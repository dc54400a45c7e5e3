"""The wide entries (``flash_attn_fwd_wide``, ``flash_attn_bwd_wide``: head_dim
above 128) on the CPU.

Their kernels cannot run here, so their tilings are emulated in plain
PyTorch and held against the JAX package's ``attention(impl="flash")`` vjp,
whose ``_fwd_kernel`` and ``_dq_kernel`` / ``_dkv_kernel`` run in Pallas
interpret mode (jitted once a shape), and against the plain versions:

- the forward (``csrc/flash_attn_fwd_wide_bf16.cu`` in bf16,
  ``csrc/flash_attn_fwd_wide.cu`` in f32): O cut into slices of at most 256
  columns (``_wide_slices``), S summed over 64-column chunks once a 64-key
  tile for each slice, an online softmax in the log2 domain, P rounded to
  the operands' dtype before P V, the row sum of the unrounded P;
- the bf16 backward (``csrc/flash_attn_bwd_wide.cu``): a dK/dV kernel over
  64-key tiles and a dQ kernel over 64-query tiles, each recomputing S and dP
  over all of D with the slice's own chunks last, P rounded before dV and dS
  before dQ and dK, the gradients in the same slices;
- the f32 backward (``csrc/flash_attn_bwd_wide_f32.cu``): one 128-thread
  slot a 64-column chunk, two a CTA, the CTAs of a key tile in a cluster that
  sums the slots' partial S and dP in a fixed order, so S and dP are computed
  once a (key tile, query tile) pair, dQ summed over key tiles in the walk's
  order (``tests/test_torch_attention_f32_bwd.py::_f32_bwd_emulated``).

At head dims 192, 256, 320 and 512 (one slice of three and of four chunks,
two slices of three (the last one two) and of four), Nq != Nk, both layouts,
f32 and bf16. The slice geometry is read from the sources.

Tolerances are ``tests/test_torch_attention_headdim.py``'s ``TOL``: f32,
atol 1e-5 (O) and 5e-5 (gradients), the same formulas summed in another
order; bf16, atol and rtol 2e-2 (gradients: of their largest magnitude), one
bf16 ulp of the output on both sides plus the order of the f32 sums.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videogpa_tpu.ops.attention as jattn
from test_torch_attention_f32_bwd import _f32_bwd_emulated
from test_torch_attention_headdim import TOL, _randn, _wide_fwd_emulated
from videogpa_torch.ops import attention as tattn

torch.set_num_threads(2)

_CSRC = Path(tattn.__file__).resolve().parents[1] / "csrc"
_WIDE_SOURCES = ("flash_attn_fwd_wide_bf16.cu", "flash_attn_bwd_wide.cu", "flash_attn_fwd_wide.cu")
BLOCK = 64
# chunks of 64 columns a slice holds at most, as the sources cut D
MAX_SLICE = int(re.search(r"constexpr int kMaxSlice = (\d+);",
                          (_CSRC / _WIDE_SOURCES[0]).read_text()).group(1))
# (D, Nq, Nk, layout)
CASES = [(192, 100, 70, "bnhd"), (256, 70, 130, "bhnd"), (320, 130, 65, "bhnd"),
         (512, 65, 100, "bnhd")]


@functools.lru_cache(maxsize=None)
def _jax_vjp(layout, dtype_name):
    """The JAX flash route's O and gradients, jitted, Pallas in interpret
    mode (``INTERPRET`` is read while the function traces)."""
    jdt = jnp.dtype(dtype_name)

    def run(q, k, v, do):
        o, vjp = jax.vjp(lambda a, b, c: jattn.attention(a, b, c, impl="flash", block_q=128,
                                                         block_k=128, layout=layout),
                         *(x.astype(jdt) for x in (q, k, v)))
        return (o, *vjp(do.astype(jdt)))

    return jax.jit(run)


def _jax_flash(q, k, v, do, layout, dtype):
    jattn.INTERPRET = True
    try:
        out = _jax_vjp(layout, "float32" if dtype == torch.float32 else "bfloat16")(q, k, v, do)
        return [np.asarray(jnp.asarray(x, jnp.float32)) for x in out]
    finally:
        jattn.INTERPRET = False


def _bhnd(x, layout):
    return x.transpose(1, 2) if layout == "bnhd" else x


def _chunk_order(nc, c0, live):
    """The order in which the backward kernels take a streamed tile's
    64-column chunks: the other slices' chunks first, then the slice's own
    [c0, c0 + live) (``chunk_at`` in ``csrc/flash_attn_bwd_wide.cu``)."""
    return [c for c in range(nc) if not c0 <= c < c0 + live] + list(range(c0, c0 + live))


def _wide_slices(D):
    """(slices, chunks a slice) at head_dim ``D``, as the sources cut D's
    64-column chunks (``slices_of``): one slice up to ``MAX_SLICE`` chunks,
    above ceil(nc / MAX_SLICE) slices of equal width, the last possibly
    narrower."""
    nc = D // BLOCK
    n = -(-nc // MAX_SLICE)
    return n, -(-nc // n)


def _slices(D):
    """(first chunk, chunks) of each slice at head_dim ``D``."""
    n, ncs = _wide_slices(D)
    nc = D // BLOCK
    return [(s * ncs, min(ncs, nc - s * ncs)) for s in range(n)]


def _products(x, u, y, w, order):
    """X U^T and Y W^T summed over 64-column chunks in ``order``."""
    a1 = a2 = 0.0
    for c in order:
        cs = slice(BLOCK * c, BLOCK * (c + 1))
        a1 = a1 + x[..., cs] @ u[..., cs].mT
        a2 = a2 + y[..., cs] @ w[..., cs].mT
    return a1, a2


def _bwd_wide_emulated(q, k, v, o, lse, do, scale, dtype):
    """The bf16 wide backward's tiling on (B, H, N, D) f32 images of operands
    of ``dtype`` and the natural-log LSE (B, H, Nq): a prologue (delta, the
    base-2 LSE); for each slice, the dK/dV kernel (a 64-key tile walks the
    64-query tiles: S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q)
    and the dQ kernel (a 64-query tile walks the 64-key tiles: S, dP, dQ +=
    dS K). Returns (dQ, dK, dV) in ``dtype``."""
    Nq, Nk, D = q.shape[2], k.shape[2], q.shape[3]
    nc = D // BLOCK
    sl2 = scale * tattn._LOG2E
    lse2 = lse * tattn._LOG2E
    delta = (o * do).sum(-1)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for c0, live in _slices(D):
        order = _chunk_order(nc, c0, live)
        cols = slice(BLOCK * c0, BLOCK * (c0 + live))
        for k0 in range(0, Nk, BLOCK):  # the dK/dV kernel
            ks = slice(k0, k0 + BLOCK)
            gk = torch.zeros(k.shape[:2] + (min(BLOCK, Nk - k0), BLOCK * live))
            gv = torch.zeros_like(gk)
            for q0 in range(0, Nq, BLOCK):
                qs = slice(q0, q0 + BLOCK)
                st, dpt = _products(k[:, :, ks], q[:, :, qs], v[:, :, ks], do[:, :, qs], order)
                pt = torch.exp2(st * sl2 - lse2[:, :, None, qs])
                dst = pt * (dpt - delta[:, :, None, qs])
                gv = gv + pt.to(dtype).float() @ do[:, :, qs, cols]
                gk = gk + dst.to(dtype).float() @ q[:, :, qs, cols]
            dk[:, :, ks, cols] = gk * scale
            dv[:, :, ks, cols] = gv
        for q0 in range(0, Nq, BLOCK):  # the dQ kernel
            qs = slice(q0, q0 + BLOCK)
            gq = torch.zeros(q.shape[:2] + (min(BLOCK, Nq - q0), BLOCK * live))
            for k0 in range(0, Nk, BLOCK):
                ks = slice(k0, k0 + BLOCK)
                s, dp = _products(q[:, :, qs], k[:, :, ks], do[:, :, qs], v[:, :, ks], order)
                p = torch.exp2(s * sl2 - lse2[:, :, qs, None])
                ds = p * (dp - delta[:, :, qs, None])
                gq = gq + ds.to(dtype).float() @ k[:, :, ks, cols]
            dq[:, :, qs, cols] = gq * scale
    return tuple(x.to(dtype) for x in (dq, dk, dv))


def _operands(D, Nq, Nk, layout, dtype, seed):
    shape = (lambda n: (1, n, 2, D)) if layout == "bnhd" else (lambda n: (1, 2, n, D))
    q, k, v, do = _randn(seed, shape(Nq), shape(Nk), shape(Nk), shape(Nq))
    # the numpy images of the dtype's values, as both packages see them
    return [torch.from_numpy(x).to(dtype).float().numpy() for x in (q, k, v, do)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D,Nq,Nk,layout", CASES)
def test_wide_forward_tiling_matches_jax_and_the_plain_version(D, Nq, Nk, layout, dtype):
    q, k, v, do = _operands(D, Nq, Nk, layout, dtype, D + Nq)
    want_o = _jax_flash(q, k, v, do, layout, dtype)[0]
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    _, ncs = _wide_slices(D)
    got = _wide_fwd_emulated(*(_bhnd(x.float(), layout) for x in (tq, tk, tv)), D ** -0.5, dtype,
                             slice_cols=BLOCK * ncs)
    got = _bhnd(got, layout).float().numpy()
    plain = tattn.flash_attn_fwd_wide(tq, tk, tv, layout=layout)[0]  # CPU: the plain version
    atol = TOL[dtype][0]
    rtol = 0 if dtype == torch.float32 else atol
    np.testing.assert_allclose(got, want_o, atol=atol, rtol=rtol)
    np.testing.assert_allclose(got, plain.float().numpy(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D,Nq,Nk,layout", CASES)
def test_two_kernel_backward_tiling_matches_jax_and_the_plain_version(D, Nq, Nk, layout, dtype):
    q, k, v, do = _operands(D, Nq, Nk, layout, dtype, 7 * D + Nk)
    _, *want = _jax_flash(q, k, v, do, layout, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    o, lse = tattn.flash_attn_fwd_reference(tq, tk, tv, layout=layout, with_lse=True)
    got = _bwd_wide_emulated(*(_bhnd(x.float(), layout) for x in (tq, tk, tv, o)), lse,
                             _bhnd(tdo.float(), layout), D ** -0.5, dtype)
    plain = tattn.flash_attn_bwd_wide(tq, tk, tv, o, lse, tdo, layout=layout)  # CPU: plain
    atol = TOL[dtype][1]
    rtol = 0 if dtype == torch.float32 else atol
    for g, p, w in zip(got, plain, want):
        g = _bhnd(g, layout).float().numpy()
        scale = 1.0 if dtype == torch.float32 else max(1.0, float(np.abs(w).max()))
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=atol * scale, rtol=rtol)
        np.testing.assert_allclose(g, p.float().numpy(), atol=atol * scale, rtol=rtol)


@pytest.mark.parametrize("D,Nq,Nk,layout", CASES)
def test_f32_cluster_backward_tiling_matches_jax_and_the_plain_version(D, Nq, Nk, layout):
    """The f32 backward's tiling (one cluster of two-slot CTAs, S and dP once
    a tile pair) on the operands of the two-kernel test, against the JAX
    vjp in interpret mode and the plain version, f32 atol 5e-5."""
    q, k, v, do = _operands(D, Nq, Nk, layout, torch.float32, 7 * D + Nk)
    _, *want = _jax_flash(q, k, v, do, layout, torch.float32)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = tattn.flash_attn_fwd_reference(tq, tk, tv, layout=layout, with_lse=True)
    got = _f32_bwd_emulated(*(_bhnd(x, layout) for x in (tq, tk, tv, o)), lse,
                            _bhnd(tdo, layout), D ** -0.5)
    plain = tattn.flash_attn_bwd_wide(tq, tk, tv, o, lse, tdo, layout=layout)  # CPU: plain
    atol = TOL[torch.float32][1]
    for g, p, w in zip(got, plain, want):
        g = _bhnd(g, layout).numpy()
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)
        np.testing.assert_allclose(g, p.numpy(), atol=atol, rtol=0)


def test_wide_slices_follow_the_sources():
    """The three wide sources cut D's 64-column chunks into slices of at most
    four the same way (``_wide_slices``): every chunk in exactly one slice,
    every slice but the last full, three or four chunks a slice."""
    for name in _WIDE_SOURCES:
        src = (_CSRC / name).read_text()
        assert int(re.search(r"constexpr int kMaxSlice = (\d+);", src).group(1)) == MAX_SLICE == 4
        assert int(re.search(r"constexpr int kChunk = (\d+);", src).group(1)) == BLOCK
        assert "nc + kMaxSlice - 1) / kMaxSlice" in src
    for D in range(192, 4097, 64):
        n, ncs = _wide_slices(D)
        nc = D // BLOCK
        assert 3 <= ncs <= MAX_SLICE and (n - 1) * ncs < nc <= n * ncs
        assert sum(live for _, live in _slices(D)) == nc
    assert [_wide_slices(d) for d in (192, 256, 320, 512, 576)] == [
        (1, 3), (1, 4), (2, 3), (2, 4), (3, 3)]
    assert _chunk_order(5, 3, 2) == [0, 1, 2, 3, 4] and _chunk_order(8, 0, 4) == [
        4, 5, 6, 7, 0, 1, 2, 3]
