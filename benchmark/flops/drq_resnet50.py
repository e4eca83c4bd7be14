"""The work of `drq_resnet50`'s loop: ResNet-v1-50 per camera, trained (every
convolution in each critic loss's forward, input gradient but the stem's,
and weight gradient): the 7x7 stride-2 stem, a 3x3 stride-2 max-pool, then
3, 4, 6 and 3 bottleneck blocks (1x1, 3x3 with the stage's stride, 1x1 to
4x the width; the first block of every stage projects its residual by a
strided 1x1 convolution), then the learned-embedding head and its
bottleneck after the dropout. `layers(config)` lists one frame's
convolutions in the order the backbone runs them."""

from benchmark.counting import Encoder, conv_out, drq_calls


def layers(config):
    """[(name, multiply-adds a frame)] of the backbone's convolutions, in
    order, and the map's (side, channels)."""
    enc = config["encoder"]
    size = conv_out(config["image_size"], 7, 2, "SAME")
    out = [("conv_init", size * size * enc["widths"][0] * 3 * 49)]
    size = conv_out(size, 3, 2, "SAME")  # the max-pool
    cin, i = enc["widths"][0], 0
    for stage, width in enumerate(enc["widths"]):
        for block in range(enc["stage_sizes"][stage]):
            stride = 2 if stage > 0 and block == 0 else 1
            wide = width * enc["expansion"]
            after = conv_out(size, 3, stride, "SAME")
            out += [(f"blocks.{i}.convs.0", size * size * width * cin),
                    (f"blocks.{i}.convs.1", after * after * width * width * 9),
                    (f"blocks.{i}.convs.2", after * after * wide * width)]
            if cin != wide or stride != 1:
                out.append((f"blocks.{i}.conv_proj", after * after * wide * cin))
            size, cin, i = after, wide, i + 1
    return out, (size, cin)


def calls(config, traffic):
    convs, (size, cin) = layers(config)
    enc = config["encoder"]
    f = enc["num_spatial_blocks"]
    start = [("conv", macs, True) for _, macs in convs]
    start.append(("einsum", size * size * cin * f, True))
    encoder = Encoder(start=tuple(start), frozen=(), bottleneck_in=cin * f,
                      bottleneck_dim=enc["bottleneck_dim"], bottleneck_after_dropout=True)
    return drq_calls(config, traffic, encoder)
