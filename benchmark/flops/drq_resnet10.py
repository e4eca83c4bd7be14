"""The work of `drq_resnet10`'s loop: the frozen ResNet-10 per camera (7x7
stride-2 stem, a 3x3 stride-2 max-pool, one basic block per stage at widths
64-512, the later stages striding 2 with a 1x1 projection), forward only,
then the trained learned-embedding head and its bottleneck after the dropout."""

from benchmark.counting import Encoder, conv_out, drq_calls


def calls(config, traffic):
    enc = config["encoder"]
    size = conv_out(config["image_size"], 7, 2, "SAME")
    frozen = [size * size * enc["widths"][0] * 3 * 49]  # the stem
    size = conv_out(size, 3, 2, "SAME")  # the max-pool
    cin = enc["widths"][0]
    for stage, width in enumerate(enc["widths"]):
        for block in range(enc["stage_sizes"][stage]):
            stride = 2 if stage > 0 and block == 0 else 1
            size = conv_out(size, 3, stride, "SAME")
            frozen += [size * size * width * cin * 9, size * size * width * width * 9]
            if cin != width or stride != 1:
                frozen.append(size * size * width * cin)  # the 1x1 projection
            cin = width
    f = enc["num_spatial_blocks"]
    encoder = Encoder(start=(("einsum", size * size * cin * f, True),), frozen=tuple(frozen),
                      bottleneck_in=cin * f, bottleneck_dim=enc["bottleneck_dim"],
                      bottleneck_after_dropout=True)
    return drq_calls(config, traffic, encoder)
