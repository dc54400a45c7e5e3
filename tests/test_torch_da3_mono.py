"""The port's DA3 mono / metric net (``videogpa_torch/models/da3/mono.py``),
the DPT head's DA3 options and ``convert_da3_mono`` against the JAX
package's on the CPU in f32. Weights: a tree shaped as JAX's ``mono_init``
gives it (``random_jax_tree``), carried into the port by the bridge; inputs
made with numpy. Mirrors ``tests/test_da3.py``'s ``TestMonoPreset`` and
``tests/test_da3_parity.py``'s mono DPT case. Limit: 1e-5 relative norm."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videogpa_tpu.models.da3 import DA3Config as JaxDA3Config
from videogpa_tpu.models.da3 import convert as jconv
from videogpa_tpu.models.da3 import mono as jmono
from videogpa_tpu.models.vggt import heads as jvheads
from videogpa_torch.convert import load_jax_params, state_dict_from_jax
from videogpa_torch.models.da3 import DA3Config, DA3Mono, mono_init
from videogpa_torch.models.da3 import convert as tconv
from videogpa_torch.models.da3 import mono as tmono
from videogpa_torch.models.vggt import heads as tvheads
from test_torch_bridge import random_jax_tree

torch.set_num_threads(2)
REL = 1e-5
# the JAX package's mono test config, and one whose out layers skip blocks
CFGS = {
    "mono_tiny": dict(img_size=28, embed_dim=32, depth=4, num_heads=2, alt_start=-1,
                      out_layers=(0, 1, 2, 3), dpt_features=16,
                      dpt_out_channels=(16, 16, 16, 16)),
    "gapped": dict(img_size=28, embed_dim=32, depth=6, num_heads=2, alt_start=-1,
                   out_layers=(1, 2, 4, 5), dpt_features=16, dpt_out_channels=(8, 16, 24, 32)),
}
_j_mono = jax.jit(jmono.mono_forward, static_argnums=(2, 3, 4))
_j_dpt = jax.jit(jvheads.dpt_head_forward, static_argnums=(2, 3),
                 static_argnames=("activation", "feature_only", "use_pos_embed", "with_conf",
                                  "inplace_relu"))


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def nets():
    """Per config: (JAX config, JAX tree, the port's net on the bridged tree)."""
    out = {}
    for name, kw in CFGS.items():
        jcfg = JaxDA3Config(**kw)
        tree = random_jax_tree(jmono.mono_init, jcfg, seed=3)
        model = load_jax_params(DA3Mono(DA3Config(**kw)), tree).eval()
        out[name] = (jcfg, tree, model)
    return out


def test_mono_init_builds_the_jax_tree():
    """``mono_init`` gives the bridge's image of JAX's ``mono_init`` tree:
    no camera token, no alternating blocks, an Identity head norm, the sky
    branch; trunk in the asked dtype, head f32."""
    jcfg, cfg = JaxDA3Config(**CFGS["gapped"]), DA3Config(**CFGS["gapped"])
    want = state_dict_from_jax(random_jax_tree(jmono.mono_init, jcfg))
    model = mono_init(cfg, torch.Generator().manual_seed(0), device="cpu",
                      dtype=torch.bfloat16)
    got = model.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert not any(k.startswith("head.norm") for k in got)
    assert model.backbone.pos_embed.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.head.parameters())
    assert (dataclasses.asdict(tmono.mono_config()) == dataclasses.asdict(jmono.mono_config())
            == dataclasses.asdict(DA3Config.mono_large()))


@pytest.mark.parametrize("kw", [{"large": True}, {"large": False}, {}],
                         ids=["large", "not_large", "default"])
def test_mono_config_takes_large_as_jax_does(kw):
    """``mono_config(large=...)`` is accepted and ignored, as in the JAX
    package (the port's took no argument and raised ``TypeError``)."""
    want = dataclasses.asdict(jmono.mono_config(**kw))
    assert dataclasses.asdict(tmono.mono_config(**kw)) == want
    if kw:
        assert dataclasses.asdict(tmono.mono_config(kw["large"])) == want


@pytest.mark.parametrize("name", list(CFGS))
def test_mono_forward_matches_jax(nets, name):
    """Depth and sky of a clip of 2 views at a non-square size (the
    pos-embed interpolated), f32 on both sides."""
    jcfg, tree, model = nets[name]
    x = np.random.default_rng(1).standard_normal((1, 2, 3, 28, 42)).astype(np.float32)
    want = _j_mono(tree, jnp.asarray(x), jcfg, "xla", jnp.float32)
    with torch.no_grad():
        got = tmono.mono_forward(model, _t(x))
    for k in ("depth", "sky"):
        assert got[k].shape == want[k].shape == (1, 2, 28, 42), k
        assert _rel(got[k].numpy(), want[k]) <= REL, (k, _rel(got[k].numpy(), want[k]))
    assert (got["depth"] > 0).all() and (got["sky"] >= 0).all()
    assert len(tmono.mono_vit_forward(model.backbone, _t(x[0]))) == 4  # the out layers only


@pytest.mark.parametrize("postprocess", [False, True])
def test_mono_inference_matches_jax(nets, postprocess):
    jcfg, tree, model = nets["mono_tiny"]
    frames = np.random.default_rng(4).integers(0, 256, (2, 28, 28, 3), dtype=np.uint8)
    want = jmono.mono_inference(tree, frames, jcfg, attn_impl="xla",
                                compute_dtype=jnp.float32, sky_postprocess=postprocess)
    got = tmono.mono_inference(model, frames, compute_dtype=torch.float32,
                               sky_postprocess=postprocess)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 28, 28) and g.dtype == w.dtype
        assert _rel(g, w) <= REL


def test_sky_postprocess_matches_jax_bit_for_bit():
    rng = np.random.default_rng(5)
    depth = rng.uniform(1, 10, (400, 300)).astype(np.float32)  # > 100,000 pixels: subsampled
    sky = np.zeros_like(depth)
    sky[:60] = 1.0
    for s in (sky, None, np.ones_like(depth)):
        np.testing.assert_array_equal(tmono.apply_mono_sky_postprocess(depth, s),
                                      jmono.apply_mono_sky_postprocess(depth, s))
    np.testing.assert_array_equal(tmono.compute_sky_mask(sky), jmono.compute_sky_mask(sky))


@pytest.mark.parametrize("case", ["mono_sky", "feature_only"])
def test_dpt_head_options_match_jax(case):
    """The DPT head's DA3 options on their own: the mono head (Identity norm,
    C-wide tokens, no pos-embed, no confidence, the sky branch) and the
    feature-only head (GSDPT's), both with DA3's raw-x fusion residual."""
    from videogpa_tpu.models.vggt.config import VGGTConfig as JaxVGGTConfig

    from videogpa_torch.models.vggt.config import VGGTConfig

    kw = dict(embed_dim=16, num_register_tokens=0, dpt_features=16,
              dpt_out_channels=(8, 16, 16, 24), dpt_intermediate_layers=(0, 1, 2, 3))
    jcfg, cfg = JaxVGGTConfig(**kw), VGGTConfig(**kw)
    if case == "mono_sky":
        init_kw = dict(output_dim=1, dim_in=16, sky_head=True, input_norm=False)
        fwd_kw = dict(use_pos_embed=False, with_conf=False, inplace_relu=False)
        C = 16
    else:
        init_kw = dict(output_dim=0, feature_only=True)
        fwd_kw = dict(inplace_relu=False)
        C = 32
    tree = random_jax_tree(lambda k, c: jvheads.dpt_head_init(k, c, **init_kw), jcfg, seed=6)
    head = load_jax_params(tvheads.DPTHead(cfg, **init_kw), tree).eval()
    tokens = np.random.default_rng(7).standard_normal((4, 1, 3, 1 + 6, C)).astype(np.float32)
    want = _j_dpt(tree, jnp.asarray(tokens), jcfg, (28, 42), activation="exp",
                  feature_only=case == "feature_only", **fwd_kw)
    with torch.no_grad():
        got = tvheads.dpt_head_forward(head, _t(tokens), cfg, (28, 42), chunk_size=2, **fwd_kw)
    if case == "feature_only":
        got, want = (got,), (want,)
    else:
        assert got[1] is None and want[1] is None
        got, want = (got[0], got[2]), (want[0], want[2])
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w) <= REL


def _mono_checkpoint(cfg, head_norm: bool, seed=8):
    """A da3metric-layout checkpoint: ``export_da3`` of a random port net
    (the keys ``convert_da3_mono`` reads) plus keys no converter reads."""
    model = mono_init(cfg, torch.Generator().manual_seed(seed), device="cpu")
    sd = tconv.export_da3(model)
    rng = np.random.default_rng(seed)
    if head_norm:
        sd["head.norm.weight"] = rng.standard_normal(cfg.embed_dim).astype(np.float32)
        sd["head.norm.bias"] = rng.standard_normal(cfg.embed_dim).astype(np.float32)
    sd["backbone.pretrained.mask_token"] = np.zeros((1, cfg.embed_dim), np.float32)
    return sd


@pytest.mark.parametrize("head_norm", [False, True], ids=["identity_norm", "layer_norm"])
def test_convert_da3_mono_matches_jax(head_norm):
    """A synthetic checkpoint in the mono key layout through JAX's
    ``convert_da3_mono`` + the bridge and through the port's converter: equal
    key for key; the converted net loads strictly and runs."""
    kw = CFGS["gapped"]
    sd = _mono_checkpoint(DA3Config(**kw), head_norm)
    want = {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree.map(np.asarray, jconv.convert_da3_mono(sd, JaxDA3Config(**kw)))).items()}
    got = tconv.convert_da3_mono(sd, DA3Config(**kw))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert ("head.norm.weight" in got) == head_norm
    model = DA3Mono(DA3Config(**kw), input_norm=head_norm)
    model.load_state_dict({k: _t(v) for k, v in got.items()}, strict=True)
    with pytest.raises(KeyError):
        tconv.convert_da3_mono({k: v for k, v in sd.items()
                                if not k.startswith("head.scratch.sky")}, DA3Config(**kw))


def test_mono_forward_bf16_trunk_runs():
    """The metric branch as the nested net runs it: bf16 trunk, f32 head."""
    cfg = DA3Config(**CFGS["mono_tiny"])
    model = mono_init(cfg, torch.Generator().manual_seed(9), device="cpu", dtype=torch.bfloat16)
    x = torch.randn(1, 2, 3, 28, 28, generator=torch.Generator().manual_seed(10))
    with torch.no_grad():
        out = tmono.mono_forward(model, x, compute_dtype=torch.bfloat16)
    assert out["depth"].dtype == torch.float32 and torch.isfinite(out["depth"]).all()
