"""Boundary-strength inputs for the tests of ops.cuda_kernels.deblock_bs
against hevc.deblock.derive_bs: one edge a branch of the derivation, and
random maps that reach every branch. numpy only (no jax), so the card's
test file can use them too."""
import numpy as np

from x265_tpu_torch.hevc.deblock import NOPOC

H4, W4 = 6, 7            # the grid of a branch case
UNI = (0, NOPOC)         # list 0 only, POC 0


def _side(intra=False, cbf=False, poc=UNI, mv=((0, 0), (0, 0)), edge=True):
    return dict(intra=intra, cbf=cbf, poc=poc, mv=mv, edge=edge)


A, B = (5, -3), (-7, 2)
# name -> (p side, q side, the bS of the edge between them); q is the
# block right of (vertical) or below (horizontal) p
CASES = {
    "intra_p": (_side(intra=True), _side(), 2),
    "intra_q": (_side(), _side(intra=True), 2),
    "intra_and_cbf": (_side(intra=True), _side(cbf=True), 2),
    "cbf_p": (_side(cbf=True), _side(), 1),
    "cbf_q": (_side(), _side(cbf=True), 1),
    "uni_same_poc": (_side(mv=(A, B)), _side(mv=(A, A)), 0),
    "uni_other_poc": (_side(), _side(poc=(4, NOPOC)), 1),
    "uni_l0_against_l1": (_side(poc=(4, NOPOC), mv=(A, B)),
                          _side(poc=(NOPOC, 4), mv=(B, A)), 0),
    "dmv_x3": (_side(mv=((1, 0), B)), _side(mv=((4, 0), B)), 0),
    "dmv_x4": (_side(mv=((1, 0), B)), _side(mv=((5, 0), B)), 1),
    "dmv_x-4": (_side(mv=((1, 0), B)), _side(mv=((-3, 0), B)), 1),
    "dmv_y3": (_side(mv=((0, -2), B)), _side(mv=((0, 1), B)), 0),
    "dmv_y4": (_side(mv=((0, -2), B)), _side(mv=((0, 2), B)), 1),
    "dmv_extremes": (_side(mv=((-32768, 0), B)), _side(mv=((32767, 0), B)),
                     1),
    "bi_straight": (_side(poc=(0, 8), mv=(A, B)),
                    _side(poc=(0, 8), mv=((7, -3), (-7, 5))), 0),
    "bi_crossed": (_side(poc=(0, 8), mv=(A, B)),
                   _side(poc=(8, 0), mv=(B, A)), 0),
    "bi_same_refs_crossed": (_side(poc=(4, 4), mv=(A, B)),
                             _side(poc=(4, 4), mv=(B, A)), 0),
    "bi_neither_mv": (_side(poc=(0, 8), mv=(A, B)),
                      _side(poc=(0, 8), mv=(A, (-7, 6))), 1),
    "bi_neither_poc": (_side(poc=(0, 8), mv=(A, B)),
                       _side(poc=(0, 4), mv=(A, B)), 1),
    "bi_crossed_far": (_side(poc=(0, 8), mv=(A, B)),
                       _side(poc=(8, 0), mv=(B, (9, -3))), 1),
    "uni_next_to_bi": (_side(), _side(poc=(0, 8)), 1),
    "bi_next_to_uni": (_side(poc=(0, 8)), _side(poc=(NOPOC, 8)), 1),
    "nopoc_both_sides": (_side(poc=(NOPOC, NOPOC)),
                         _side(poc=(NOPOC, NOPOC)), 1),
    "nopoc_one_side": (_side(poc=(NOPOC, NOPOC)), _side(), 1),
    "no_edge": (_side(intra=True), _side(cbf=True, edge=False), 0),
    # q in the picture's first column (row): its p under derive_bs's roll
    # is the last column (row), intra, and the edge is still 0
    "picture_edge": (_side(intra=True), _side(intra=True), 0),
}


def case_maps(name, vertical):
    """(edge_v, edge_h, is_intra4, cbf4, mv4, refpoc4, (row, col) of q,
    the bS expected there) of one branch case on an H4 x W4 grid whose
    other blocks are alike (list 0, POC 0, zero motion, every edge set)."""
    p, q, want = CASES[name]
    edge_v = np.ones((H4, W4), bool)
    edge_h = np.ones((H4, W4), bool)
    intra = np.zeros((H4, W4), bool)
    cbf = np.zeros((H4, W4), bool)
    mv4 = np.zeros((H4, W4, 2, 2), np.int32)
    refpoc4 = np.full((H4, W4, 2), NOPOC, np.int64)
    refpoc4[..., 0] = 0
    if name == "picture_edge":
        qpos, ppos = (((2, 0), (2, W4 - 1)) if vertical
                      else ((0, 2), (H4 - 1, 2)))
    else:
        qpos = (2, 3) if vertical else (3, 2)
        ppos = (2, 2)
    for pos, s in ((ppos, p), (qpos, q)):
        intra[pos] = s["intra"]
        cbf[pos] = s["cbf"]
        refpoc4[pos] = s["poc"]
        mv4[pos] = s["mv"]
    (edge_v if vertical else edge_h)[qpos] = q["edge"]
    return edge_v, edge_h, intra, cbf, mv4, refpoc4, qpos, want


def random_maps(rng, h4, w4):
    """(edge_v, edge_h, is_intra4, cbf4, mv4 int32, refpoc4 int64) that
    reach every branch: intra and cbf blocks, each list use (list 0, list
    1, both, none), POCs that match and differ, motion whose differences
    fall on both sides of 4 quarter-pels, and blocks that copy their left
    or top neighbour's motion straight or with the lists crossed."""
    edge_v = rng.random((h4, w4)) < 0.7
    edge_h = rng.random((h4, w4)) < 0.7
    intra = rng.random((h4, w4)) < 0.12
    cbf = rng.random((h4, w4)) < 0.2
    use = rng.choice(4, size=(h4, w4), p=[0.35, 0.15, 0.4, 0.1])
    pocs = rng.choice([0, 4, 8], size=(h4, w4, 2))
    refpoc4 = np.where(((use[..., None] + 1) & [1, 2]) > 0, pocs,
                       NOPOC).astype(np.int64)
    refpoc4[use == 3] = NOPOC
    refpoc4[intra] = NOPOC
    mv4 = rng.choice([-4, 0, 1, 3, 4, 8], size=(h4, w4, 2, 2))
    mv4 = mv4.astype(np.int32)
    for ax in (0, 1):
        copy = rng.random((h4, w4)) < 0.25
        cross = rng.random((h4, w4)) < 0.3
        nmv = np.roll(mv4, 1, ax)
        npoc = np.roll(refpoc4, 1, ax)
        cmv = np.where(cross[..., None, None], nmv[..., ::-1, :], nmv)
        cpoc = np.where(cross[..., None], npoc[..., ::-1], npoc)
        mv4 = np.where(copy[..., None, None], cmv, mv4)
        refpoc4 = np.where(copy[..., None], cpoc, refpoc4)
    return edge_v, edge_h, intra, cbf, mv4, refpoc4
