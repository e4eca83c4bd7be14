"""The work of `toy_trained`'s loop: ResNet-10 per camera, trained (every
convolution in each critic loss's forward, input gradient but the stem's,
and weight gradient), then the learned-embedding head and its bottleneck."""

from benchmark.counting import Encoder, conv_out, drq_calls


def calls(config, traffic):
    enc = config["encoder"]
    size = conv_out(config["image_size"], 7, 2, "SAME")
    start = [("conv", size * size * enc["widths"][0] * 3 * 49, True)]
    size = conv_out(size, 3, 2, "SAME")
    cin = enc["widths"][0]
    for stage, width in enumerate(enc["widths"]):
        for block in range(enc["stage_sizes"][stage]):
            stride = 2 if stage > 0 and block == 0 else 1
            size = conv_out(size, 3, stride, "SAME")
            start += [("conv", size * size * width * cin * 9, True),
                      ("conv", size * size * width * width * 9, True)]
            if cin != width or stride != 1:
                start.append(("conv", size * size * width * cin, True))
            cin = width
    f = enc["num_spatial_blocks"]
    start.append(("einsum", size * size * cin * f, True))
    encoder = Encoder(start=tuple(start), frozen=(), bottleneck_in=cin * f,
                      bottleneck_dim=enc["bottleneck_dim"], bottleneck_after_dropout=True)
    return drq_calls(config, traffic, encoder)
