"""K3, DrQ's random crop, against serl_tpu's on the CPU.

The port takes its window offsets explicitly; the tests replay the draw of
serl_tpu's `_crop_indices` (jax.random.randint(key, (B, 2), 0, 2 * pad + 1)
from the key the crop is given) and feed the same offsets to the port. The
crop copies pixels, so the result must equal JAX's exactly: uint8 images
through `batched_random_crop` (JAX's one-hot bf16 matmul form) and
`batched_random_crop_gather`, with one and two leading batch dims, and float
images (which JAX sends to its gather form).
"""

import jax
import numpy as np
import pytest
import torch

from serl_tpu.vision import augmentations as jaug
from serl_tpu_torch.vision import augmentations as aug

PAD = 4


def _jax_offsets(key, b):
    return torch.from_numpy(np.array(jax.random.randint(key, (b, 2), 0, 2 * PAD + 1))).long()


@pytest.mark.parametrize("shape,num_batch_dims,dtype", [
    ((6, 16, 20, 3), 1, np.uint8),
    ((3, 2, 16, 20, 3), 2, np.uint8),
    ((3, 2, 12, 12, 3), 2, np.float32),
])
def test_torch_crop_matches_jax(shape, num_batch_dims, dtype):
    rng = np.random.default_rng(0)
    img = (rng.integers(0, 256, shape).astype(dtype) if dtype == np.uint8
           else rng.normal(size=shape).astype(dtype))
    key = jax.random.PRNGKey(3)
    b = int(np.prod(shape[:num_batch_dims]))
    offsets = _jax_offsets(key, b)
    got = aug.batched_random_crop(torch.from_numpy(img), offsets, padding=PAD,
                                  num_batch_dims=num_batch_dims)
    for jfn in (jaug.batched_random_crop, jaug.batched_random_crop_gather):
        want = np.asarray(jfn(img, key, padding=PAD, num_batch_dims=num_batch_dims))
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)
    # the crop really moved pixels: the offsets span their range
    assert offsets.min() >= 0 and offsets.max() <= 2 * PAD and len(offsets.unique()) > 2


def test_torch_crop_images_crops_each_image_with_its_offsets():
    rng = np.random.default_rng(1)
    imgs = [torch.from_numpy(rng.integers(0, 256, (5, 1, 8, 8, 3)).astype(np.uint8))
            for _ in range(4)]
    g = torch.Generator().manual_seed(0)
    offsets = [aug.crop_offsets(5, PAD, g) for _ in imgs]
    outs = aug.crop_images(imgs, offsets, padding=PAD, num_batch_dims=2)
    for img, off, out in zip(imgs, offsets, outs):
        torch.testing.assert_close(out, aug.batched_random_crop_gather(
            img, off, padding=PAD, num_batch_dims=2), rtol=0, atol=0)
    # the centre offset (pad, pad) is the identity
    same = aug.batched_random_crop(imgs[0], torch.full((5, 2), PAD), padding=PAD,
                                   num_batch_dims=2)
    torch.testing.assert_close(same, imgs[0], rtol=0, atol=0)
    with pytest.raises(ValueError):
        aug.batched_random_crop(imgs[0], offsets[0][:4], padding=PAD, num_batch_dims=2)


@pytest.mark.cuda
def test_torch_crop_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    for shape, dtype in (((64, 3, 32, 32, 3), torch.uint8), ((16, 1, 12, 10, 3), torch.uint8),
                         ((16, 1, 12, 12, 3), torch.float32)):
        img = (torch.randint(0, 256, shape, generator=g, device="cuda").to(dtype))
        offs = [aug.crop_offsets(shape[0] * shape[1], PAD, g, "cuda") for _ in range(2)]
        before = aug.crop_images.launches
        got = aug.crop_images([img, img.clone()], offs, padding=PAD, num_batch_dims=2)
        assert aug.crop_images.launches == before + 1
        for out, off in zip(got, offs):
            torch.testing.assert_close(out, aug.batched_random_crop_gather(
                img, off, padding=PAD, num_batch_dims=2), rtol=0, atol=0)
