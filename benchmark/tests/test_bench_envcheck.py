"""The pixel rule's surfaces: every face of a box is a surface of its own, as
the plain renderer lights each face apart, so a one-ulp flip between two
faces of one box lies on a surface edge like a flip between two primitives."""

import torch

from benchmark import envcheck
from benchmark.reference import pick
from benchmark.reference.env import rendering


def test_box_faces_are_surfaces_of_their_own():
    g = torch.Generator().manual_seed(3)
    state = pick.fresh(torch.rand((8, 2), generator=g) * 0.1, torch.arange(8), torch.float32)
    phys = pick.physics(state, torch.float32)
    first_box = 1 + rendering.N_SPH + rendering.N_CAP
    for ids in envcheck.surface_ids(phys, 64):
        prim, face = ids // 8, ids % 8
        assert bool((face[(ids >= 0) & (prim < first_box)] == 0).all())
        boxes = ids[prim >= first_box]
        assert boxes.unique().numel() > (boxes // 8).unique().numel()  # faces apart
        # a pixel between two faces of one box is on a surface edge
        edges = envcheck.surface_edge_mask(ids)
        two_faces = envcheck.surface_edge_mask(torch.where(prim >= first_box, ids, -1)) & (
            prim >= first_box)
        assert bool(edges[two_faces].all())
