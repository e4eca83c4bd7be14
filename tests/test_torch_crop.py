"""K3, DrQ's random crop, against serl_tpu's on the CPU.

The port takes its window offsets explicitly; the tests replay the draw of
serl_tpu's `_crop_indices` (jax.random.randint(key, (B, 2), 0, 2 * pad + 1)
from the key the crop is given) and feed the same offsets to the port. The
crop copies pixels, so the result must equal JAX's exactly: uint8 images
through `batched_random_crop` (JAX's one-hot bf16 matmul form) and
`batched_random_crop_gather`, with one and two leading batch dims, and float
images (which JAX sends to its gather form).

The kernel's own per-thread code (csrc/random_crop.cuh, built for the CPU by
g++ from tests/k3_host.cpp) must equal the plain gather exactly at every
offset (dy, dx) in [0, 2 pad]^2, on rows that take each of its copy paths:
16-byte units, 4-byte words and bytes, with bases 16-byte aligned or 4
bytes off; and a fault planted in a copy of the header must show.
"""

import ctypes
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from serl_tpu.vision import augmentations as jaug
from serl_tpu_torch.vision import augmentations as aug
from tests import torch_k2

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


def _host_crop(img, offsets, out=None, csrc=torch_k2.CSRC):
    """K3's per-thread code on the CPU over one image batch (B, H, W, C),
    into `out` if given: (crop, unit taken)."""
    lib = torch_k2.host_library("k3_host.cpp", "random_crop.cuh", csrc)
    lib.k3_host_crop.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
    lib.k3_host_crop.restype = ctypes.c_int
    out = torch.empty_like(img) if out is None else out
    b, h, w, c = img.shape
    unit = lib.k3_host_crop(img.data_ptr(), out.data_ptr(), offsets.data_ptr(), b, h, w,
                            c * img.element_size(), PAD)
    return out, unit


def _view_off(raw, nbytes, shape, dtype, base_offset):
    """A (shape, dtype) view of the uint8 buffer `raw` whose base lies
    `base_offset` bytes past a 16-byte boundary."""
    start = (16 - raw.data_ptr() % 16) % 16 + base_offset
    view = raw[start:start + nbytes].view(dtype).view(shape)
    assert view.data_ptr() % 16 == base_offset
    return view


def _every_offset_batch(w, c, dtype, base_offset):
    """One image per (dy, dx) in [0, 2 PAD]^2, 10 rows each, `base_offset`
    bytes past a 16-byte boundary; an output buffer as far off; the offsets."""
    offsets = torch.tensor([(dy, dx) for dy in range(2 * PAD + 1) for dx in range(2 * PAD + 1)])
    shape = (offsets.shape[0], 10, w, c)
    nbytes = int(np.prod(shape)) * torch.tensor([], dtype=dtype).element_size()
    raw = torch.from_numpy(np.random.default_rng(0).integers(0, 256, nbytes + 32, np.uint8))
    return (_view_off(raw, nbytes, shape, dtype, base_offset),
            _view_off(torch.empty(nbytes + 32, dtype=torch.uint8), nbytes, shape, dtype,
                      base_offset), offsets)


@pytest.mark.parametrize("w,c,dtype,base_offset,unit", [
    (128, 3, torch.uint8, 0, 16), (128, 3, torch.uint8, 4, 4),  # DrQ's 384-byte rows
    (84, 3, torch.uint8, 0, 4), (84, 3, torch.uint8, 4, 4),     # 252 bytes: words
    (33, 1, torch.uint8, 0, 1), (33, 1, torch.uint8, 4, 1),     # 33 bytes: bytes
    (16, 4, torch.uint8, 0, 16), (16, 4, torch.uint8, 4, 4),    # 64 bytes
    (16, 3, torch.float32, 0, 16),                              # 192-byte float rows
])
def test_torch_crop_kernel_code_equals_plain(w, c, dtype, base_offset, unit):
    img, out, offsets = _every_offset_batch(w, c, dtype, base_offset)
    got, got_unit = _host_crop(img, offsets, out)
    assert got_unit == unit
    want = aug.batched_random_crop_gather(img, offsets, padding=PAD)
    # bytes, not values: random bytes as floats hold NaNs
    assert torch.equal(got.contiguous().view(torch.uint8), want.contiguous().view(torch.uint8))


# Faults planted in a copy of random_crop.cuh: (what, text, replacement)
K3_FAULTS = [
    ("row clamp stops a row short", "clampi(i + dy - s.pad, 0, s.h - 1)",
     "clampi(i + dy - s.pad, 0, s.h - 2)"),
    ("left edge replicates the second pixel", "row[k - s.pad_bytes] = row[k % s.pixel_bytes]",
     "row[k - s.pad_bytes] = row[s.pixel_bytes + k % s.pixel_bytes]"),
    ("funnel shift in nibbles", "const int q = (o & 15) >> 2, bits = (o & 3) * 8;",
     "const int q = (o & 15) >> 2, bits = (o & 3) * 4;"),
]


@pytest.mark.parametrize("what,text,replacement", K3_FAULTS, ids=[f[0] for f in K3_FAULTS])
def test_torch_crop_kernel_code_planted_fault_fails(tmp_path, what, text, replacement):
    source = (Path(torch_k2.CSRC) / "random_crop.cuh").read_text()
    assert source.count(text) == 1, what
    (tmp_path / "random_crop.cuh").write_text(source.replace(text, replacement))
    img, _, offsets = _every_offset_batch(128, 3, torch.uint8, 0)
    got, unit = _host_crop(img, offsets, csrc=str(tmp_path))
    assert unit == 16
    assert not torch.equal(got, aug.batched_random_crop_gather(img, offsets, padding=PAD)), what


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
