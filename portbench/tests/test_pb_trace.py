"""The trace reduction: idle time as the gaps in the union of device
intervals (overlapping kernels counted once), groups, gaps by host span."""

import pytest

from portbench import readers, trace


def test_union_counts_overlap_once():
    spans = [(0.0, 4.0), (1.0, 2.0), (3.0, 6.0), (8.0, 9.0), (8.5, 10.0)]
    assert trace.union_length(spans) == pytest.approx(8.0)
    assert trace.union_length([]) == 0.0


def test_gaps_inside_the_window():
    spans = [(1.0, 4.0), (2.0, 3.0), (6.0, 7.0)]
    assert trace.gaps(spans, 0.0, 10.0) == [(0.0, 1.0), (4.0, 6.0), (7.0, 10.0)]


@pytest.mark.parametrize("name,group", [
    ("void flash_attn_fwd_kernel<64>(...)", "attention_fwd"),
    ("flash_attn_bwd_main", "attention_bwd"),
    ("flash_attn_bwd_prologue", "attention_bwd"),
    ("nvjet_hsh_256x128_64x4_1x2_h_bz_coopA_NNT", "gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "gemm"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel", "conv"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "other"),
    ("Memcpy DtoD (Device -> Device)", "other"),
])
def test_kernel_groups(name, group):
    assert trace.kernel_group(name) == group


def _event(name, start, end, device):
    return (name, device, start, end)


def test_summarize_a_synthetic_trace():
    ev = [
        _event(trace.WINDOW_SPAN, 1000.0, 11000.0, False),
        _event("aten::mm", 1000.0, 1100.0, False),
        _event("aten::item", 5000.0, 7000.0, False),
        _event("flash_attn_fwd_kernel", 1000.0, 4000.0, True),
        _event("nvjet_gemm", 2000.0, 5000.0, True),       # overlaps the attention
        _event("elementwise_kernel", 7000.0, 10000.0, True),
        _event("setup_kernel", 0.0, 500.0, True),         # before the window
    ]
    s = trace.summarize(ev)
    assert s["window_s"] == pytest.approx(0.010)
    assert s["busy_s"] == pytest.approx(0.007)         # 1000-5000 and 7000-10000 us
    assert s["group_s"]["attention_fwd"] == pytest.approx(0.003)
    assert s["group_s"]["gemm"] == pytest.approx(0.003)
    assert s["idle_gaps"][0] == ["aten::item", pytest.approx(0.002)]
    assert s["idle_gaps"][1] == ["no host span", pytest.approx(0.001)]
    ctx = {"kind": "train-dpo", "units": 2, "wall_s": 0.01, "trace": s,
           "work": {"model_flops": 1.0, "attn_flops": 989e12 * 0.001, "attn_bytes": 1.0,
                    "gemm_flops": 0.0, "gemm_bytes": 3.35e12 * 0.0003},
           "peak": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}}
    assert readers.idle_pct(ctx, "train-dpo") == pytest.approx(30.0)
    assert readers.roofline(ctx, "train-dpo", "attn", readers.ATTENTION) == pytest.approx(
        100.0 * 2 * 0.001 / 0.003)
    assert readers.roofline(ctx, "train-dpo", "gemm", readers.GEMM) == pytest.approx(20.0)
    assert readers.other_ms(ctx, "train-dpo") == pytest.approx(1.5)
    assert readers.idle_pct(ctx, "other-kind") is None


def test_no_device_operation_reads_nothing():
    ev = [_event(trace.WINDOW_SPAN, 0.0, 10.0, False), _event("aten::add", 1.0, 2.0, False)]
    assert trace.summarize(ev) is None
    ctx = {"kind": "train-dpo", "units": 1, "wall_s": 1.0, "trace": None, "work": {},
           "peak": None}
    assert readers.idle_pct(ctx, "train-dpo") is None
    assert readers.mfu(ctx, "train-dpo") is None


def test_events_of_a_real_profile_leave_out_annotations():
    import torch

    with trace.traced(True) as prof:
        with trace.window_span():
            torch.ones(64, 64) @ torch.ones(64, 64)
    evts = trace.events(prof)
    assert any(e[0] == trace.WINDOW_SPAN and not e[1] for e in evts)
    assert not any(e[1] and e[0].startswith("portbench.") for e in evts)
