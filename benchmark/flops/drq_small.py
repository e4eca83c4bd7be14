"""The work of `drq_small`'s loop: SERL's SmallEncoder per camera (4 trained
3x3 convolutions, VALID, then the spatial mean and a 256-wide bottleneck)."""

from benchmark.counting import Encoder, conv_out, drq_calls


def calls(config, traffic):
    enc = config["encoder"]
    size, cin, start = config["image_size"], 3, []
    for cout, k, s in zip(enc["features"], enc["kernel_sizes"], enc["strides"]):
        size = conv_out(size, k, s, enc["padding"])
        start.append(("conv", size * size * cout * cin * k * k, True))
        cin = cout
    encoder = Encoder(start=tuple(start), frozen=(), bottleneck_in=cin,
                      bottleneck_dim=enc["bottleneck_dim"], bottleneck_after_dropout=False)
    return drq_calls(config, traffic, encoder)
