"""The CUDA-core backwards (``csrc/flash_attn_bwd_f32.cu``: the float32 entry
of K3/K7 at head_dim 16-64; ``csrc/flash_attn_bwd_wide_f32.cu``: the float32
entry at 128 of ``flash_attn_bwd_f32`` and above 128 of
``flash_attn_bwd_wide``) on the CPU; the bf16 wide entry's scratch on
``meta`` operands (its tiling: ``tests/test_torch_attention_wide.py``).

The kernels cannot run here, so their tiling is emulated in plain PyTorch:
delta = rowsum(O * dO) in a prologue; one work item per 64-key tile (the
tile is read from the source) walking the 64-query tiles in the order
``_walk`` gives (the kernel's order, as its header states it); at head_dim
64 and below S and dP over all of D; above, one 128-thread slot for each
64-column chunk, two slots a CTA, the CTAs of a key tile in a cluster
(``_groups``, the cut read from the wide source): each slot's partial S and
dP over its chunks, each CTA's two summed, the CTAs' sums added in the
order of their ranks, so S and dP are computed once for each (key tile,
query tile) pair, and each slot's own chunk of dK, dV and of the query
tile's dQ partial (each over two halves of the key tile); dK and dV
accumulated across the walk, and each query tile's dQ partials added in the
walk's order; P rounded to bf16 before dV and dS before dQ and dK for bf16
operands; ragged last tiles on both sides. The emulation is held against
``flash_attn_bwd_reference`` and against the JAX package's ``_flash`` vjp
(its Pallas backward in interpret mode), in float32 at head dims 16-256
and in bf16 at 256, Nq != Nk, both layouts (at 192-512 also in
``tests/test_torch_attention_wide.py``), and at 576 and 1,088 (a spare
slot; two groups of chunks) against the plain version. The walk itself is checked:
each key tile visits every query tile once, tiles that start together
visit different query tiles at each step, every tile's partials are added
once, and the closed form the kernel computes a key tile's place with
(``dq_rank``) gives that order; both sources start the diagonal walk by a
cooperative launch. On ``meta`` operands with the C entry recorded, the
wrappers launch at B*H = 70,000 with their scratch sized, and
``attention()`` under grad takes K6's f32 entry and the f32 backward on the
card's route.

Tolerances: atol 2e-5 between the emulation and the plain version in f32
(the same formulas, other summation orders), 5e-4 against JAX, as
``tests/test_torch_attention_grad.py`` holds the port's gradients to the
JAX flash vjp; in bf16 atol and rtol 2e-2 of the gradient's largest
magnitude, as ``tests/test_torch_attention_headdim.py`` holds bf16
gradients (a bf16 rounding of P or dS that lands the other way moves a
gradient by about one bf16 ulp).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videogpa_tpu.ops.attention as jattn
from videogpa_torch.ops import attention as tattn

torch.set_num_threads(2)

_SRC = Path(tattn.__file__).resolve().parents[1] / "csrc" / "flash_attn_bwd_f32.cu"
_WIDE_SRC = _SRC.with_name("flash_attn_bwd_wide_f32.cu")
BLOCK = int(re.search(r"constexpr int kBlock = (\d+);", _SRC.read_text()).group(1))
# the wide kernel's chunk (one slot's columns), slots a CTA and largest cluster
CHUNK, SLOTS, MAX_CLUSTER = (
    int(re.search(rf"constexpr int {name} = (\d+);", _WIDE_SRC.read_text()).group(1))
    for name in ("kChunk", "kSlots", "kMaxCluster"))


@pytest.fixture(autouse=True)
def interpret_mode():
    jattn.INTERPRET = True
    yield
    jattn.INTERPRET = False


def _randn(seed, *shapes):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s, dtype=np.float32) for s in shapes)


def _walk(n_qt: int, n_kt: int, grid: int):
    """The kernel's walk: for each key tile j, the query tiles in the order
    it visits them, and for each query tile the key tiles in the order their
    dQ partials are added.

    While a head's key tiles fit the persistent grid (``n_kt <= grid``), key
    tile j visits query tile (t - j) mod n_qt at its step t, and a tile's
    partials are added by (step, j): tiles that start together never wait on
    each other. Otherwise the tiles are visited in order and added in order
    of j (at one key tile the two orders are one)."""
    if n_kt > grid:
        return [list(range(n_qt)) for _ in range(n_kt)], [list(range(n_kt)) for _ in range(n_qt)]
    visits = [[(t - j) % n_qt for t in range(n_qt)] for j in range(n_kt)]
    adds = [sorted(range(n_kt), key=lambda j, i=i: ((i + j) % n_qt, j)) for i in range(n_qt)]
    return visits, adds


def _clusters(D: int):
    """(groups, CTAs a cluster) of the wide kernel at head_dim ``D``
    (``clusters_of`` in the source): D's 64-column chunks in groups of at
    most ``SLOTS * MAX_CLUSTER``, as even as they go, ``SLOTS`` chunks a
    CTA."""
    nc = D // CHUNK
    groups = -(-nc // (SLOTS * MAX_CLUSTER))
    slots = -(-nc // groups)
    return groups, -(-slots // SLOTS)


def _groups(D: int):
    """The wide kernel's cut of D: for each group, for each CTA of its
    cluster in rank order, for each of its slots, the chunks whose partial S
    and dP the slot sums, in its order (slot, slot + S, ... for the
    cluster's S slots, the chunk it owns moved last), and the chunk it owns
    (None for a spare slot)."""
    nc = D // CHUNK
    n_groups, cluster = _clusters(D)
    n_slots = SLOTS * cluster
    n_ch = -(-nc // n_slots)
    out = []
    for grp in range(n_groups):
        ctas = []
        for r in range(cluster):
            slots = []
            for sub in range(SLOTS):
                slot = SLOTS * r + sub
                own = grp * n_slots + slot
                order = list(range(n_ch))
                if own < nc:
                    order.remove(grp)
                    order.append(grp)
                mine = [slot + n_slots * w for w in order if slot + n_slots * w < nc]
                slots.append((mine, own if own < nc else None))
            ctas.append(slots)
        out.append(ctas)
    return out


def _f32_bwd_emulated(q, k, v, o, lse, do, scale, dtype=torch.float32, grid=264):
    """The kernels' prologue and work items on (B, H, N, D) f32 images of
    operands of ``dtype``, walking the tiles as ``_walk`` gives: at D <= 64
    one CTA a key tile on a grid of ``grid`` CTAs (two an SM); above, a
    cluster of CTAs of two 64-column slots (``_groups``) on ``grid / 2 /
    cluster`` clusters (one CTA an SM), S and dP summed as the cluster sums
    them: each CTA's two slots' partials, slot 0's first, then the CTAs'
    sums in rank order."""
    Nq, Nk, D = q.shape[2], k.shape[2], q.shape[3]
    n_qt, n_kt = -(-Nq // BLOCK), -(-Nk // BLOCK)
    width = min(D, CHUNK)
    groups = _groups(D) if D > CHUNK else [[[([0], 0)]]]
    visits, adds = _walk(n_qt, n_kt, grid if D <= CHUNK else grid // 2 // len(groups[0]))

    def cols(c):
        return slice(c * width, (c + 1) * width)

    def rnd(x):
        return x.to(dtype).float()

    delta = (o * do).sum(-1)  # prologue
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    partial = {}
    for j in range(n_kt):  # one work item a key tile
        k0 = j * BLOCK
        kt, vt = k[:, :, k0:k0 + BLOCK], v[:, :, k0:k0 + BLOCK]
        half = min(BLOCK // 2, kt.shape[2])  # the two halves of the key tile
        acc_k, acc_v = torch.zeros_like(kt), torch.zeros_like(vt)
        for i in visits[j]:
            sl = slice(i * BLOCK, (i + 1) * BLOCK)
            for ctas in groups:  # a cluster: S^T and dP^T once for its chunks
                s_t = dp_t = 0.0
                for slots in ctas:
                    cs_ = cd_ = 0.0  # the CTA's sum of its slots' partials
                    for mine, _ in slots:
                        ps = pd = 0.0
                        for c in mine:
                            ps = ps + kt[..., cols(c)] @ q[:, :, sl, cols(c)].mT
                            pd = pd + vt[..., cols(c)] @ do[:, :, sl, cols(c)].mT
                        cs_, cd_ = cs_ + ps, cd_ + pd
                    s_t, dp_t = s_t + cs_, dp_t + cd_
                p_t = torch.exp2(s_t * (scale * tattn._LOG2E) - lse[:, :, None, sl] * tattn._LOG2E)
                ds_t = rnd(p_t * (dp_t - delta[:, :, None, sl]))
                for _, own in (x for slots in ctas for x in slots):  # each slot its own chunk
                    if own is None:
                        continue
                    cs = cols(own)
                    acc_v[..., cs] += rnd(p_t) @ do[:, :, sl, cs]
                    acc_k[..., cs] += ds_t @ q[:, :, sl, cs]
                    partial[i, j, own] = (ds_t[:, :, :half].mT @ kt[:, :, :half, cs]
                                          + ds_t[:, :, half:].mT @ kt[:, :, half:, cs])
        dk[:, :, k0:k0 + BLOCK], dv[:, :, k0:k0 + BLOCK] = acc_k * scale, acc_v
    dq = torch.zeros_like(q)
    for i in range(n_qt):  # the partials in their order, the last times the scale
        for c in range(D // width):
            acc = partial[i, adds[i][0], c].clone()
            for j in adds[i][1:]:
                acc += partial[i, j, c]
            dq[:, :, i * BLOCK:(i + 1) * BLOCK, cols(c)] = acc * scale
    return dq, dk, dv


def _jax_vjp(q, k, v, do):
    """The JAX ``_flash`` vjp in f32 (``attention(impl="flash")``)."""
    _, vjp = jax.vjp(lambda a, b, c: jattn.attention(a, b, c, impl="flash", block_q=128,
                                                     block_k=128),
                     *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("nq,nk,d", [(150, 150, 16), (70, 200, 32), (257, 129, 64),
                                     (64, 10, 128), (10, 10, 128), (130, 70, 256)])
def test_emulated_tiling_matches_the_plain_version_and_jax(nq, nk, d):
    q, do = (torch.from_numpy(x) for x in _randn(d + nq, (1, 2, nq, d), (1, 2, nq, d)))
    k, v = (torch.from_numpy(x) for x in _randn(d + nk + 1, (1, 2, nk, d), (1, 2, nk, d)))
    o, lse = tattn.flash_attn_fwd_reference(q, k, v, layout="bhnd", with_lse=True)
    got = _f32_bwd_emulated(q, k, v, o, lse, do, d ** -0.5)
    want = tattn.flash_attn_bwd_f32(q, k, v, o, lse, do, layout="bhnd")  # CPU: plain version
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=0)
    for g, w in zip(got, _jax_vjp(q.numpy(), k.numpy(), v.numpy(), do.numpy())):
        np.testing.assert_allclose(g.numpy(), w, atol=5e-4, rtol=0)


def test_bnhd_wrapper_and_a_non_default_scale_match_the_plain_formulas():
    """The wrapper's layouts and ``softmax_scale`` (what a padded head_dim
    passes): the emulation at the given scale equals the bnhd plain version."""
    q, k, v, do = (torch.from_numpy(x) for x in _randn(3, *[(1, 90, 3, 32)] * 4))
    scale = 24 ** -0.5
    o, lse = tattn.flash_attn_fwd_reference(q, k, v, layout="bnhd", with_lse=True,
                                            softmax_scale=scale)
    got = tattn.flash_attn_bwd_f32(q, k, v, o, lse, do, layout="bnhd", softmax_scale=scale)
    tr = [x.transpose(1, 2) for x in (q, k, v, o, do)]
    want = _f32_bwd_emulated(*tr[:4], lse, tr[4], scale)
    for g, w in zip(got, want):
        assert g.is_contiguous()
        torch.testing.assert_close(g.transpose(1, 2), w, atol=2e-5, rtol=0)


def test_emulated_tiling_in_bf16_matches_the_plain_version_and_jax():
    """This tiling with bf16 rounding at D = 256 (P and dS rounded where the
    JAX kernels round them) against the wide entry's plain version and the
    JAX vjp on the same bf16 operands."""
    d, nq, nk = 256, 100, 130
    q, do = (torch.from_numpy(x).to(torch.bfloat16) for x in _randn(5, *[(1, 2, nq, d)] * 2))
    k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _randn(6, *[(1, 2, nk, d)] * 2))
    o, lse = tattn.flash_attn_fwd_reference(q, k, v, layout="bhnd", with_lse=True)
    got = _f32_bwd_emulated(*(x.float() for x in (q, k, v, o)), lse, do.float(), d ** -0.5,
                            dtype=torch.bfloat16)
    want = tattn.flash_attn_bwd_wide(q, k, v, o, lse, do, layout="bhnd")  # CPU: plain version
    _, vjp = jax.vjp(lambda a, b, c: jattn.attention(a, b, c, impl="flash", block_q=128,
                                                     block_k=128),
                     *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)))
    jax_grads = vjp(jnp.asarray(do.float().numpy(), jnp.bfloat16))
    for g, w, jw in zip(got, want, jax_grads):
        w = w.float()
        jw = np.asarray(jnp.asarray(jw, jnp.float32))
        scale = max(1.0, float(w.abs().max()))
        atol = 2e-2 * scale
        torch.testing.assert_close(g.to(torch.bfloat16).float(), w, atol=atol, rtol=2e-2)
        np.testing.assert_allclose(g.numpy(), jw, atol=atol, rtol=2e-2)


def _rank(i, t, j, n_qt, n_kt):
    """The kernel's closed form for key tile j's place among query tile i's
    contributors, visited at its step t (``dq_rank`` in the source)."""
    a, b = divmod(n_kt, n_qt)
    s0 = (n_qt - i) % n_qt
    if s0 + t <= n_qt:
        below_b = max(0, min(s0 + t, b) - s0)
    else:
        below_b = max(0, b - s0) + min(b, s0 + t - n_qt)
    return a * t + below_b + j // n_qt


@pytest.mark.parametrize("n_qt,n_kt,grid", [(22, 22, 264), (64, 64, 132), (5, 13, 264),
                                            (13, 5, 264), (1, 7, 264), (7, 1, 264),
                                            (3, 141, 132)])
def test_the_walk_visits_every_tile_once_and_adds_in_the_kernels_order(n_qt, n_kt, grid):
    visits, adds = _walk(n_qt, n_kt, grid)
    for j in range(n_kt):
        assert sorted(visits[j]) == list(range(n_qt))
    for i in range(n_qt):
        assert sorted(adds[i]) == list(range(n_kt))
    if n_kt > grid:  # more key tiles than CTAs: in order, added in order of j
        assert all(a == list(range(n_kt)) for a in adds)
        return
    for t in range(n_qt):  # tiles that start together never meet at a step
        tiles = [visits[j][t] for j in range(min(n_kt, n_qt))]
        assert len(set(tiles)) == len(tiles)
    for j in range(n_kt):
        for t, i in enumerate(visits[j]):
            assert adds[i].index(j) == _rank(i, t, j, n_qt, n_kt)
            # a key tile's partial comes after those added at earlier steps
            assert all(visits[jj].index(i) <= t for jj in adds[i][:adds[i].index(j)])


def test_the_diagonal_walk_starts_only_with_the_whole_grid_resident():
    """The diagonal walk can make a key tile wait on one taken later, so the
    source chooses it exactly where ``_walk`` does (several key tiles that
    fit the grid) and starts it by a cooperative launch, falling back to the
    in-order walk where the card refuses one."""
    src = _SRC.read_text()
    assert "p.diag = p.n_kt > 1 && p.n_kt <= grid ? 1 : 0;" in src
    coop = re.search(r"if \(p\.diag\) \{(.*?)\n  \}\n  bwd_kernel<DC><<<", src, re.S)
    assert coop is not None
    body = coop.group(1)
    assert "cudaLaunchCooperativeKernel" in body and "bwd_kernel<DC>" in body
    assert "cudaErrorCooperativeLaunchTooLarge" in body and "p.diag = 0;" in body
    assert src.count("<<<grid, kThreads") == 1  # the in-order walk's plain launch


def test_the_wide_kernel_walks_diagonally_only_on_a_cooperative_launch_of_clusters():
    """The wide kernel's grid counts clusters: it walks diagonally where
    ``_walk`` does with that many, starts that launch with the cooperative
    attribute beside the cluster's, and on any refusal runs the in-order
    walk with the cluster attribute alone."""
    src = _WIDE_SRC.read_text()
    assert "const int grid = static_cast<int>(items < n_active ? items : n_active);  // clusters" \
        in src
    assert "p.diag = p.n_kt > 1 && p.n_kt <= grid ? 1 : 0;" in src
    assert "cudaOccupancyMaxActiveClusters" in src
    assert "attr[0].id = cudaLaunchAttributeClusterDimension;" in src
    assert "attr[1].id = cudaLaunchAttributeCooperative;" in src
    coop = re.search(r"if \(p\.diag\) \{(.*?)\n  \}\n  g_last_walk = 0;", src, re.S)
    assert coop is not None
    body = coop.group(1)
    assert "cfg.numAttrs = 2;" in body and "cudaLaunchKernelEx" in body
    assert "p.diag = 0;" in body and "cfg.numAttrs = 1;" in body
    assert src.count("cudaLaunchKernelEx(") == 2


def test_cluster_geometry_follows_the_source():
    """``_clusters`` is the source's ``clusters_of``: one cluster of
    ceil(D / 128) CTAs of two 64-column slots up to 1,024 columns, above
    groups of at most ``SLOTS * MAX_CLUSTER`` chunks; every chunk is owned
    once, and summed once in every group."""
    src = _WIDE_SRC.read_text()
    assert (MAX_CLUSTER, SLOTS, CHUNK, BLOCK) == (8, 2, 64, 64)
    assert "*n_groups = (*nc + kSlots * kMaxCluster - 1) / (kSlots * kMaxCluster);" in src
    assert "const int slots = (*nc + *n_groups - 1) / *n_groups;" in src
    assert "*cluster = (slots + kSlots - 1) / kSlots;" in src
    assert [_clusters(d) for d in (128, 192, 256, 320, 512, 576, 1024, 1088, 2112)] == [
        (1, 1), (1, 2), (1, 2), (1, 3), (1, 4), (1, 5), (1, 8), (2, 5), (3, 6)]
    for D in range(128, 4097, 64):
        nc = D // CHUNK
        groups = _groups(D)
        owned = [own for ctas in groups for slots in ctas for _, own in slots if own is not None]
        assert sorted(owned) == list(range(nc))
        for ctas in groups:
            assert len(ctas) <= MAX_CLUSTER
            assert sorted(c for slots in ctas for mine, _ in slots for c in mine) == list(range(nc))
            assert all(own is None or mine[-1] == own for slots in ctas for mine, own in slots)
    assert _groups(192)[0][1][1] == ([], None)  # a spare slot: chunk 3 does not exist
    # 1,088 columns: the second group's last CTA only adds to the contraction
    assert _groups(1088)[1][3] == [([6, 16], 16), ([7], None)]
    assert _groups(1088)[1][4] == [([8], None), ([9], None)]


@pytest.mark.parametrize("nq,nk,d", [(70, 130, 576), (65, 100, 1088)])
def test_emulated_groups_of_chunks_match_the_plain_version(nq, nk, d):
    """At 576 columns (one cluster of five CTAs, a spare slot) and above
    1,024 (1,088: two groups, each computing S and dP again, the second with
    spare slots): the emulation still gives the plain version's
    gradients."""
    q, do = (torch.from_numpy(x) for x in _randn(d + nq, (1, 2, nq, d), (1, 2, nq, d)))
    k, v = (torch.from_numpy(x) for x in _randn(d + nk + 1, (1, 2, nk, d), (1, 2, nk, d)))
    o, lse = tattn.flash_attn_fwd_reference(q, k, v, layout="bhnd", with_lse=True)
    got = _f32_bwd_emulated(q, k, v, o, lse, do, d ** -0.5)
    want = tattn.flash_attn_bwd_wide(q, k, v, o, lse, do, layout="bhnd")  # CPU: plain version
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=0)


def test_every_kernel_ab_variant_applies_to_the_sources(tmp_path):
    """``kernel_ab.py --variant`` reverts one design choice of this tree's
    kernels by regular-expression substitutions (the wide backward's in-order
    walk, K8 f32's two consumer warpgroups, its integer-add conversion, ...);
    each still finds its pattern in the sources (``make_variant`` raises
    otherwise)."""
    import kernel_ab

    assert {"f32_bwd_wide_in_order", "int8_f32_two_consumer_wgs", "int8_f32_magic",
            "int8_f32_three_stages"} <= set(kernel_ab.VARIANTS)
    for name, (source, _) in kernel_ab.VARIANTS.items():
        kernel_ab.make_variant(name, str(tmp_path / name))
        changed = (tmp_path / name / "videogpa_torch" / "csrc" / f"{source}.cu").read_text()
        assert changed != (_SRC.parent / f"{source}.cu").read_text()


def _val(arg):
    return arg.value if hasattr(arg, "value") else arg


def _record(monkeypatch):
    calls = []
    monkeypatch.setattr(tattn, "_on_card", lambda x: x.device.type == "meta")
    monkeypatch.setattr(tattn, "_call",
                        lambda fn_name, entry, device, *args: calls.append((entry, args)))
    return calls


@pytest.mark.parametrize("layout", ["bnhd", "bhnd"])
def test_f32_backward_launches_at_70000_heads(monkeypatch, layout):
    calls = _record(monkeypatch)
    shape = (2, 8, 35000, 64) if layout == "bnhd" else (2, 35000, 8, 64)
    x = torch.empty(shape, device="meta")
    lse = torch.empty((2, 35000, 8), device="meta")
    before = tattn.flash_attn_bwd_f32.launches
    dq, dk, dv = tattn.flash_attn_bwd_f32(x, x, x, x, lse, x, layout=layout)
    assert dq.shape == dk.shape == dv.shape == x.shape and dq.dtype == torch.float32
    [(entry, args)] = calls
    assert entry == "flash_attn_bwd_f32" and tattn.flash_attn_bwd_f32.launches == before + 1
    # nine operand pointers and three of scratch (delta, dQ's partial sums,
    # the turn counters), then B, H, Nq, Nk, D, 24 strides and the scale
    assert tuple(_val(a) for a in args[12:17]) == (2, 35000, 8, 8, 64)
    assert len(args) == 12 + 5 + 24 + 1
    assert args[10] is None  # one key tile: no partial sums
    with pytest.raises(TypeError, match="float32"):
        tattn.flash_attn_bwd_f32(*(t.to(torch.bfloat16) for t in (x, x, x, x)), lse,
                                 x.to(torch.bfloat16), layout=layout)


def test_attention_under_grad_takes_the_f32_entries_on_the_card_route(monkeypatch):
    calls = _record(monkeypatch)
    q = torch.empty((4, 10, 16, 128), device="meta", requires_grad=True)
    o = tattn.attention(q, q, q, layout="bnhd")
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    before = tattn.flash_attn_bwd_f32.launches
    o.sum().backward()
    # head_dim 128: the f32 backward's wrapper launches the cluster kernel
    assert [e for e, _ in calls] == ["flash_attn_fwd_f32", "flash_attn_bwd_wide_f32"]
    assert tattn.flash_attn_bwd_f32.launches == before + 1
    assert q.grad.shape == q.shape


@pytest.mark.parametrize("layout", ["bnhd", "bhnd"])
def test_wide_backward_launches_at_70000_heads_with_its_scratch(monkeypatch, layout):
    """The bf16 entry above head_dim 128 (``csrc/flash_attn_bwd_wide.cu``),
    B*H = 70,000, 130 queries and 65 keys: nine operand pointers and one f32
    scratch, the base-2 LSE and then delta over the query rows padded to
    whole 64-row tiles (3 x 64 = 192 a head), then B, H, Nq, Nk, D, the 24
    strides and the scale."""
    calls = _record(monkeypatch)
    B, H, D = 2, 35000, 256
    shape_q = (B, 130, H, D) if layout == "bnhd" else (B, H, 130, D)
    shape_k = (B, 65, H, D) if layout == "bnhd" else (B, H, 65, D)
    q = torch.empty(shape_q, dtype=torch.bfloat16, device="meta")
    k = torch.empty(shape_k, dtype=torch.bfloat16, device="meta")
    lse = torch.empty((B, H, 130), device="meta")
    before = tattn.flash_attn_bwd_wide.launches
    dq, dk, dv = tattn.flash_attn_bwd_wide(q, k, k, q, lse, q, layout=layout)
    assert dq.shape == shape_q and dk.shape == dv.shape == shape_k and dq.dtype == torch.bfloat16
    [(entry, args)] = calls
    assert entry == "flash_attn_bwd_wide_bf16" and tattn.flash_attn_bwd_wide.launches == before + 1
    assert len(args) == 10 + 5 + 24 + 1
    assert tuple(_val(a) for a in args[10:15]) == (B, H, 130, 65, D)
    assert _val(args[-1]) == pytest.approx(D ** -0.5, rel=1e-7)
    with pytest.raises(NotImplementedError, match="head_dim 200"):
        x = torch.empty((1, 10, 2, 200), device="meta")
        tattn.flash_attn_bwd_wide(x, x, x, x, torch.empty((1, 2, 10), device="meta"), x)


@pytest.mark.parametrize("layout", ["bnhd", "bhnd"])
def test_wide_f32_backward_launches_with_its_slices_scratch(monkeypatch, layout):
    """The float32 entry above head_dim 128 (the cluster kernel), B*H =
    70,000, 130 queries and 65 keys: three query tiles, two key tiles and
    four 64-column chunks, a cluster of two CTAs. The scratch is delta
    (rounded up to 16 bytes), the dQ partial sums over whole query tiles and
    a turn counter per (head, chunk, query tile) with the work counter."""
    calls = _record(monkeypatch)
    B, H, D = 2, 35000, 256
    shape_q = (B, 130, H, D) if layout == "bnhd" else (B, H, 130, D)
    shape_k = (B, 65, H, D) if layout == "bnhd" else (B, H, 65, D)
    q = torch.empty(shape_q, device="meta")
    k = torch.empty(shape_k, device="meta")
    lse = torch.empty((B, H, 130), device="meta")
    tattn._GEOMETRY.clear()
    dq, dk, dv = tattn.flash_attn_bwd_wide(q, k, k, q, lse, q, layout=layout)
    assert dq.shape == shape_q and dk.shape == dv.shape == shape_k and dq.dtype == torch.float32
    [(entry, args)] = calls
    assert entry == "flash_attn_bwd_wide_f32"
    assert tuple(_val(a) for a in args[12:17]) == (B, H, 130, 65, D)
    n_delta = -(-B * H * 130 // 4) * 4
    n_acc = B * H * 3 * 64 * D
    assert args[10] - args[9] == 4 * n_delta and args[11] - args[10] == 4 * n_acc
    assert tattn.bwd_f32_slices(D) == D // CHUNK == 4 and _clusters(D) == (1, 2)
    [((n_delta_g, n_acc_g, n_turn), _)] = [
        geo for key, geo in tattn._GEOMETRY.items() if key[0] == "flash_attn_bwd_wide_f32"]
    assert (n_delta_g, n_acc_g, n_turn) == (n_delta, n_acc, B * H * (D // CHUNK) * 3 + 1)
