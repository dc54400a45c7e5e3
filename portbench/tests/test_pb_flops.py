"""The operation counts of the configuration against numbers worked by hand
from the published shapes."""

import pytest

from portbench import flops, spec

L, DIM, TE, TXT, H, D = 42, 3072, 512, 4096, 48, 64


def _cfg(name):
    cell = spec.find_cell(name)
    return cell.config["model"], cell.config["video"]


def test_token_counts():
    assert flops.tokens(*_cfg("cogvideox-5b.train-dpo")) == (226, 13 * 30 * 45)
    assert sum(flops.tokens(*_cfg("cogvideox-5b.train-dpo"))) == 17_776


def _forward(n_vid, patch_in, batch, rank=0, out=64):
    """Operations of one DiT forward, term by term."""
    n = n_vid + 226
    per_block = (2 * batch * n * 12 * DIM * DIM          # q, k, v, out, fc1, fc2
                 + 2 * 2 * batch * TE * 6 * DIM          # the two AdaLN projections
                 + 4 * batch * H * n * n * D             # QK^T and PV
                 + 4 * 2 * 2 * batch * n * rank * DIM)   # four adapters, two products each
    return (L * per_block
            + 2 * batch * n_vid * patch_in * DIM         # patch embedding
            + 2 * batch * 226 * TXT * DIM                # text projection
            + 2 * batch * (DIM * TE + TE * TE)           # time embedding
            + 2 * batch * TE * 2 * DIM                   # output AdaLN
            + 2 * batch * n_vid * DIM * out)             # proj_out


def test_train_pair_is_two_reference_two_policy_forwards_and_two_backwards():
    model, video = _cfg("cogvideox-5b.train-dpo")
    r, n_vid = 64, 17_550
    n = n_vid + 226
    ref = _forward(n_vid, 64, 1)
    pol = _forward(n_vid, 64, 1, rank=r)
    att = 4 * H * n * n * D
    # a backward: dX of the out, fc1, fc2 projections of every block and of
    # q, k, v of blocks 1..41 (block 0's input sees no adapter), proj_out's
    # dX, each adapter product twice, attention at twice its forward
    bwd = (2 * n * DIM * DIM * ((L - 1) * 12 + 9)
           + 2 * n_vid * DIM * 64
           + L * 2 * (4 * 2 * 2 * n * r * DIM)
           + L * 2 * att)
    w = flops.train_pair(model, video, r)
    assert w["model_flops"] == pytest.approx(2 * ref + 2 * pol + 2 * bwd, rel=1e-12)
    assert w["attn_fwd_calls"] == 6 * L and w["attn_bwd_calls"] == 2 * L
    assert w["attn_flops"] == pytest.approx(6 * L * att + 2 * L * 10 * H * n * n * D, rel=1e-12)
    assert w["model_flops"] == pytest.approx(2.32e15, rel=0.03)
