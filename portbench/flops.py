"""Operations and bytes of the cells' work, from the configuration's shapes.

A matrix product of (m, k) by (k, n) is 2 m k n operations and reads and
writes each operand once (bf16, 2 bytes). Attention over (B, H, Nq, Nk, D)
is two products forward (4 B H Nq Nk D) and five backward (10 B H Nq Nk D:
S is recomputed, then dP, dV, dQ, dK); its bytes are Q, K, V and O (and
dO, dQ, dK, dV backward) once each, in bf16.

Two sums are kept apart:

- ``model``: the work the mathematics needs, for ``mfu``: forwards, and
  backwards of the activation and LoRA gradients only (the base weights are
  frozen), attention's backward at four products; no recompute.
- ``kernels``: the work the kernels are handed, for the rooflines: also the
  blocks that remat recomputes, attention's backward at five products.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

BF16 = 2


def hidden(cfg: dict) -> int:
    return cfg["num_heads"] * cfg["head_dim"]


def tokens(cfg: dict, video: dict) -> Tuple[int, int]:
    """(text tokens, video tokens) of one sample."""
    p, pt = cfg["patch_size"], cfg["patch_size_t"] or 1
    n_vid = (video["latent_frames"] // pt) * (video["latent_height"] // p) * (
        video["latent_width"] // p)
    return cfg["max_text_seq_length"], n_vid


def forward_linears(cfg: dict, video: dict, batch: int,
                    lora_rank: int = 0) -> List[Tuple[int, int, int, str]]:
    """(m, k, n, kind) of every matrix product of one DiT forward; kind is
    ``gemm`` for the linears, ``conv`` for the 2-D patch embedding (a
    convolution in the program), ``lora`` for the adapters."""
    dim, te = hidden(cfg), cfg["time_embed_dim"]
    n_txt, n_vid = tokens(cfg, video)
    n = n_txt + n_vid
    p, pt = cfg["patch_size"], cfg["patch_size_t"]
    patch = cfg["in_channels"] * (pt or 1) * p * p
    out = [
        (batch * n_vid, patch, dim, "conv" if pt is None else "gemm"),
        (batch * n_txt, cfg["text_embed_dim"], dim, "gemm"),
        (batch, dim, te, "gemm"), (batch, te, te, "gemm"),
    ]
    for _ in range(cfg["num_layers"]):
        out += [(batch, te, 6 * dim, "gemm")] * 2
        out += [(batch * n, dim, dim, "gemm")] * 4
        out += [(batch * n, dim, 4 * dim, "gemm"), (batch * n, 4 * dim, dim, "gemm")]
        if lora_rank:
            out += [(batch * n, dim, lora_rank, "lora"), (batch * n, lora_rank, dim, "lora")] * 4
    out += [(batch, te, 2 * dim, "gemm"),
            (batch * n_vid, dim, (pt or 1) * p * p * cfg["out_channels"], "gemm")]
    return out


def _flops(mkn) -> float:
    m, k, n = mkn[:3]
    return 2.0 * m * k * n


def _bytes(mkn) -> float:
    m, k, n = mkn[:3]
    return BF16 * (m * k + k * n + m * n)


def attention_fwd(cfg: dict, video: dict, batch: int) -> Tuple[float, float]:
    """(operations, bytes) of one attention call forward."""
    n = sum(tokens(cfg, video))
    h, d = cfg["num_heads"], cfg["head_dim"]
    return 4.0 * batch * h * n * n * d, BF16 * 4.0 * batch * n * h * d


def attention_bwd(cfg: dict, video: dict, batch: int) -> Tuple[float, float]:
    """(operations, bytes) of one attention call backward (five products)."""
    n = sum(tokens(cfg, video))
    h, d = cfg["num_heads"], cfg["head_dim"]
    return 10.0 * batch * h * n * n * d, BF16 * 8.0 * batch * n * h * d


def _backward_linears(cfg: dict, video: dict, rank: int) -> List[Tuple[int, int, int, str]]:
    """Products of one policy backward at batch 1: dX of every linear whose
    input depends on the adapters (all of the blocks' but block 0's q, k,
    v and both AdaLN projections, which see no adapter; the head's), and two
    products per adapter product (dX and its weight)."""
    fwd = forward_linears(cfg, video, 1, rank)
    L = cfg["num_layers"]
    first_block = 4  # the embedding products before block 0
    per_block = 8 + 8
    out = []
    for i in range(L):
        blk = fwd[first_block + i * per_block:first_block + (i + 1) * per_block]
        proj, ffn, lora = blk[2:6], blk[6:8], blk[8:]
        if i > 0:
            out += proj[:3]
        out += [proj[3]] + ffn + lora + lora
    out += fwd[-1:]  # proj_out; norm_out's AdaLN sees only the time embedding
    return out


def train_pair(cfg: dict, video: dict, rank: int, remat: bool = True) -> Dict[str, float]:
    """One preference pair (a mini-step at batch 1): two forwards of the
    frozen base model, two policy forwards and two policy backwards; remat
    recomputes the policy's blocks once more in each backward."""
    ref = forward_linears(cfg, video, 1)
    pol = forward_linears(cfg, video, 1, rank)
    bwd = _backward_linears(cfg, video, rank)
    L = cfg["num_layers"]
    a_ops, a_bytes = attention_fwd(cfg, video, 1)
    b_ops, b_bytes = attention_bwd(cfg, video, 1)
    model = (2 * sum(map(_flops, ref)) + 2 * sum(map(_flops, pol)) + 2 * sum(map(_flops, bwd))
             + L * (2 * a_ops + 2 * a_ops + 2 * 2 * a_ops))
    blocks = pol[4:-2]  # what remat recomputes: the blocks
    runs = [(ref, 2), (pol, 2), (bwd, 2)] + ([(blocks, 2)] if remat else [])
    gemm_flops = sum(c * sum(_flops(x) for x in xs if x[3] != "conv") for xs, c in runs)
    gemm_bytes = sum(c * sum(_bytes(x) for x in xs if x[3] != "conv") for xs, c in runs)
    fwd_calls = L * (4 + (2 if remat else 0))
    return {
        "model_flops": model,
        "attn_flops": fwd_calls * a_ops + 2 * L * b_ops,
        "attn_bytes": fwd_calls * a_bytes + 2 * L * b_bytes,
        "gemm_flops": gemm_flops, "gemm_bytes": gemm_bytes,
        "attn_fwd_calls": fwd_calls, "attn_bwd_calls": 2 * L,
    }
