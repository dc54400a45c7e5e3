"""CogVideoX1.5-5B through the port against the JAX package on the CPU, at
tiny widths with the 1.5 layout (patch_size_t 2, the Linear patch embed,
latents scaled by inversion), the same numpy-seeded inputs and bridged
weights in both packages:

(a) the latent frames rounded up to patch_size_t from an odd count, and
    ``dit_forward`` on them over a non-square grid; the 3D RoPE tables at the
    full 11 x 48 x 85 grid;
(b) ``sample_t2v`` end to end with dynamic CFG and inverted latent scaling,
    the JAX draws injected, its video's frame count included;
(c) the int8 mode: ``quantize_dit_int8`` and ``attn_impl="flash_int8"``
    (K8's plain version against ``_flash_int8`` in interpret mode);
(d) the full-size CogVideoX1.5-5B checkpoint key layout through
    ``convert_dit`` (shapes only, on the meta device); the layout case at
    scaled widths against the JAX converter and the bridge is a parameter of
    ``tests/test_torch_loaders.py``'s;
(e) ``CogVideoXGenerator``'s absolute LoRA merge at the recipe's 0.2 against
    the JAX generator's, and the ``--recipe CogVideoX1.5-5B`` operating point
    against ``generate/CogVideoX1.5-5B.py``'s.
"""

import dataclasses
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

import videogpa_tpu.cli.generate as jgen
import videogpa_tpu.models.cogvideox.pipeline as jp
import videogpa_tpu.models.cogvideox.vae as jv
import videogpa_tpu.models.loader as jloader
import videogpa_tpu.ops.attention as jattn
import videogpa_tpu.ops.quant as jquant
from videogpa_tpu.models.cogvideox import CogVideoXConfig as JaxConfig
from videogpa_tpu.models.cogvideox import dit_init as jax_dit_init
from videogpa_tpu.ops.rope import rope_3d_freqs as jax_rope_3d_freqs
from videogpa_torch.cli import generate as G
from videogpa_torch.convert import load_jax_params, state_dict_from_jax
from videogpa_torch.models.cogvideox import (
    CogVideoXConfig, CogVideoXTransformer, dit_forward, num_latent_frames)
from videogpa_torch.models.cogvideox import convert as tconv
from videogpa_torch.models.cogvideox import pipeline as tp
from videogpa_torch.models.cogvideox import vae as tv
from videogpa_torch.ops import quant as tquant
from videogpa_torch.ops.rope import rope_3d_freqs
from videogpa_torch.train.lora import export_peft, lora_init
from test_cogvideox_parity import OracleDiT
from test_torch_bridge import random_jax_tree
from test_torch_cogvideox import _j_dit_forward
from test_torch_cogvideox_sampling import ATOL, RTOL, _embeds, _loop_draws, _t
from test_torch_generate_cli import FakeTokenizer, _args
from test_torch_quant import INT8_FWD_ATOL, INT8_FWD_RTOL, _np

torch.set_num_threads(2)

# CogVideoX1.5's layout at tiny widths: 9 frames -> 3 latent frames, rounded
# up to 4; 48 x 80 pixels -> a 6 x 10 latent grid -> 3 x 5 patches
CFG = dataclasses.replace(CogVideoXConfig.tiny(), patch_size_t=2, sample_frames=4,
                          sample_height=6, sample_width=10, vae_invert_scale_latents=True)
JCFG = JaxConfig(**dataclasses.asdict(CFG))
FRAMES, HEIGHT, WIDTH = 9, 48, 80


@pytest.fixture(autouse=True)
def interpret_mode():
    jattn.INTERPRET = True
    yield
    jattn.INTERPRET = False


@pytest.fixture(scope="module")
def trees():
    """The DiT's and the VAE's JAX trees (seeded numpy draws) and the port's
    modules bridged from them; no test writes into them."""
    dit = random_jax_tree(jax_dit_init, JCFG, seed=15)
    vae = random_jax_tree(jv.vae_init, JCFG, seed=16)
    tdit = load_jax_params(CogVideoXTransformer(CFG), dit).requires_grad_(False)
    tvae = load_jax_params(tv.CogVideoXVAE(CFG), vae).eval()
    return dit, vae, tdit, tvae


def _latent_shape_of_jax_sample_t2v(monkeypatch, num_frames):
    """The (B, F, C, h, w) shape the JAX ``sample_t2v`` hands its loop."""
    seen = {}

    def loop(dit, txt, neg, key, cfg, settings, shape, **kw):
        seen["shape"] = shape
        return jnp.zeros(shape)

    monkeypatch.setattr(jp, "denoise_loop", loop)
    monkeypatch.setattr(jp, "decode_latents", lambda vae, lat, cfg: lat)
    jp.sample_t2v(None, None, jnp.zeros((1, 8, 32)), jnp.zeros((1, 8, 32)), JCFG,
                  jax.random.PRNGKey(0), num_frames=num_frames, height=HEIGHT, width=WIDTH)
    monkeypatch.undo()
    return seen["shape"]


# (a) f32 forwards of both packages on the same weights: the float work
# agrees to ~1e-6 a layer, held to 1e-4 as tests/test_torch_cogvideox.py's
@pytest.mark.parametrize("layout", ["bhnd", "bnhd"])
def test_dit_forward_at_rounded_up_odd_frames_on_a_non_square_grid_matches_jax(
        layout, trees, monkeypatch):
    shape = _latent_shape_of_jax_sample_t2v(monkeypatch, FRAMES)
    F = num_latent_frames(CFG, FRAMES)
    assert F == 4 and shape == (1, F, CFG.vae_latent_channels, 6, 10)  # 3 -> 4
    dit, _, tdit, _ = trees
    rng = np.random.default_rng(17)
    x = rng.standard_normal((2,) + shape[1:], dtype=np.float32)
    txt = rng.standard_normal((2, CFG.max_text_seq_length, CFG.text_embed_dim),
                              dtype=np.float32)
    t = np.array([3, 951])
    want = _j_dit_forward(dit, jnp.asarray(x), jnp.asarray(txt), jnp.asarray(t), JCFG,
                          attn_impl="flash", compute_dtype=jnp.float32, attn_layout=layout)
    with torch.no_grad():
        got = dit_forward(tdit, torch.from_numpy(x), torch.from_numpy(txt),
                          torch.from_numpy(t), compute_dtype=torch.float32, attn_layout=layout)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


# the tables are cos / sin of f32 angles (position x inverse frequency) in
# both packages; an angle's last f32 bits move its cosine by at most ~1e-5
# at the grid's largest positions (84 x 1 rad)
ROPE_ATOL = 2e-5


@pytest.mark.parametrize("grid", [(2, 3, 5), (11, 48, 85)], ids=["tiny", "cog15_full"])
def test_rope_3d_tables_match_jax(grid):
    cos, sin = rope_3d_freqs(grid, 64)
    jcos, jsin = jax.jit(jax_rope_3d_freqs, static_argnums=(0, 1))(grid, 64)
    assert cos.shape == (grid[0] * grid[1] * grid[2], 64)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=ROPE_ATOL, rtol=0)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=ROPE_ATOL, rtol=0)


# (b) three DPM steps with dynamic CFG and a decode of the inverted-scale
# latents, held to tests/test_torch_cogvideox_sampling.py's 1e-4
def test_sample_t2v_dynamic_cfg_and_inverted_latents_match_jax(trees):
    dit, vae, tdit, tvae = trees
    txt, neg = _embeds(CFG, 18)
    key, n = jax.random.PRNGKey(19), 3
    settings = jp.SamplerSettings(num_inference_steps=n, guidance_scale=6.0,
                                  use_dynamic_cfg=True)
    want = jp.sample_t2v(dit, vae, jnp.asarray(txt), jnp.asarray(neg), JCFG, key,
                         num_frames=FRAMES, height=HEIGHT, width=WIDTH, settings=settings,
                         attn_impl="xla", compute_dtype=jnp.float32)
    init, noise = _loop_draws(key, (1, 4, CFG.vae_latent_channels, 6, 10), n)
    got = tp.sample_t2v(tdit, tvae, _t(txt), _t(neg), CFG, num_frames=FRAMES, height=HEIGHT,
                        width=WIDTH, settings=tp.SamplerSettings(num_inference_steps=n,
                                                                 use_dynamic_cfg=True),
                        init_latents=init, step_noise=noise, compute_dtype=torch.float32)
    # every latent frame is decoded: 4 x (4 - 1) + 1 = 13 frames for the 9
    # asked, in both packages
    assert got.shape == tuple(np.shape(want)) == (1, 3, 13, HEIGHT, WIDTH)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tp.video_to_uint8(_t(want)), jp.video_to_uint8(want))
    # the dynamic guidance differs from the constant one on these draws
    still = tp.sample_t2v(tdit, tvae, _t(txt), _t(neg), CFG, num_frames=FRAMES,
                          height=HEIGHT, width=WIDTH,
                          settings=tp.SamplerSettings(num_inference_steps=n),
                          init_latents=init, step_noise=noise, compute_dtype=torch.float32)
    assert float((still - got).abs().max()) > 1e-3


# (c) int8 forwards of both packages on the same quantised weights,
# tests/test_torch_quant.py's tolerance (a few activations may flip an
# integer at a rounding tie); bhnd takes every attention through the
# int8-QK forward
def test_int8_dit_forward_matches_jax(trees):
    dit, _, _, _ = trees
    qtree = jquant.quantize_dit_int8(jax.tree.map(jnp.asarray, dit))
    bridged = load_jax_params(CogVideoXTransformer(CFG), _np(qtree))
    own = tquant.quantize_dit_int8(load_jax_params(CogVideoXTransformer(CFG), dit))
    rng = np.random.default_rng(20)
    x = rng.standard_normal((2, 4, CFG.in_channels, 6, 10), dtype=np.float32)
    txt = rng.standard_normal((2, CFG.max_text_seq_length, CFG.text_embed_dim),
                              dtype=np.float32)
    t = np.array([40, 700])
    want = _j_dit_forward(qtree, jnp.asarray(x), jnp.asarray(txt), jnp.asarray(t), JCFG,
                          attn_impl="flash_int8", compute_dtype=jnp.float32, attn_layout="bhnd")
    for model in (bridged, own):
        with torch.no_grad():
            got = dit_forward(model, torch.from_numpy(x), torch.from_numpy(txt),
                              torch.from_numpy(t), compute_dtype=torch.float32,
                              attn_layout="bhnd", attn_impl="flash_int8")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=INT8_FWD_ATOL,
                                   rtol=INT8_FWD_RTOL)


# (d) the real checkpoint's key grammar and shapes, without materialising it
def test_convert_dit_reads_the_full_cogvideox_1_5_layout():
    cfg = CogVideoXConfig.cogvideox_1_5_5b()
    with torch.device("meta"):
        oracle = OracleDiT(cfg)
    sd = {k: np.broadcast_to(np.float32(0), tuple(v.shape))
          for k, v in oracle.state_dict().items()}
    got = tconv.convert_dit(sd, cfg)
    module = CogVideoXTransformer(cfg, device="meta").state_dict()
    assert set(got) == set(module) and len(got) == len(sd)  # every checkpoint key read
    assert all(tuple(module[k].shape) == v.shape for k, v in got.items())
    # the Linear patch embed of pt x p x p x C inputs and its inverse at the head
    assert got["patch_embed.proj.weight"].shape == (3072, 2 * 2 * 2 * 16)
    assert got["proj_out.weight"].shape == (2 * 2 * 2 * 16, 3072)
    assert "pos_embedding" not in got  # RoPE only


# (e) the recipe's generator: the merged DiT of both packages from one PEFT
# adapter on disk, in f32 (the merge is one f32 product and add a weight)
def test_generator_merges_the_lora_at_the_absolute_scaling_as_jax(trees, tmp_path,
                                                                   monkeypatch):
    dit, _, _, _ = trees
    lora = lora_init(CFG.num_layers, CFG.hidden_dim, 4, torch.Generator().manual_seed(21),
                     device="cpu")
    for ab in lora.values():
        ab["lora_B"].data.normal_(0, 0.1, generator=torch.Generator().manual_seed(22))
    export_peft(lora, str(tmp_path / "lora"), rank=4, alpha=8.0)
    args = _args(tmp_path, {"a": "a cat"}, lora_path=str(tmp_path / "lora"), lora_weight=0.2)

    tdit = load_jax_params(CogVideoXTransformer(CFG), dit).requires_grad_(False)
    monkeypatch.setattr(G, "load_models", lambda base, cfg, device: (
        tdit, None, None, None, FakeTokenizer()))
    gen = G.CogVideoXGenerator(args, CFG, dynamic_cfg=True, lora_weight=0.2,
                               absolute_lora=True, device="cpu")
    monkeypatch.setattr(jloader, "load_cogvideox", lambda *a, **k: (
        jax.tree.map(jnp.asarray, dit), None))
    monkeypatch.setattr(jloader, "load_t5", lambda *a, **k: (None, None))
    monkeypatch.setattr(jloader, "resolve_model_dir", lambda *a, **k: "tokenizer")
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        lambda *a, **k: FakeTokenizer())
    jgenerator = jgen.CogVideoXGenerator(args, JCFG, dynamic_cfg=True, lora_weight=0.2,
                                         absolute_lora=True)
    assert gen.settings.use_dynamic_cfg and jgenerator.settings.use_dynamic_cfg
    want = state_dict_from_jax(jax.tree.map(np.asarray, jgenerator.dit))
    got = gen.dit.state_dict()
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-7, msg=k)
    # the scaling is 0.2, not alpha / r = 2: block 0's to_q moved by 0.2 B A
    base = load_jax_params(CogVideoXTransformer(CFG), dit).state_dict()
    key = "blocks.0.attn1.to_q.weight"
    ba = lora["to_q"]["lora_B"][0] @ lora["to_q"]["lora_A"][0]
    torch.testing.assert_close(got[key] - base[key], 0.2 * ba.detach(), rtol=1e-4, atol=1e-6)


def _jax_recipe_module():
    path = os.path.join(os.path.dirname(__file__), "..", "generate", "CogVideoX1.5-5B.py")
    spec = importlib.util.spec_from_file_location("jax_cogvideox_1_5_recipe", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_recipe_operating_point_matches_the_jax_wrapper(monkeypatch):
    argv = ["--prompt_json", "p.json", "--output_dir", "o"]
    seen = {}

    def capture(tag):
        def run(args, cfg, **kw):
            seen[tag] = (dataclasses.asdict(cfg), kw, args.fps, args.lora_weight)
        return run

    wrapper = _jax_recipe_module()
    monkeypatch.setattr(wrapper, "run_generation", capture("jax"))
    monkeypatch.setattr(sys, "argv", ["CogVideoX1.5-5B.py"] + argv)
    wrapper.main()
    monkeypatch.setattr(G, "run_generation", capture("torch"))
    G.main(["--recipe", "CogVideoX1.5-5B"] + argv, device="cpu")
    jcfg, jkw, jfps, jweight = seen["jax"]
    tcfg, tkw, tfps, tweight = seen["torch"]
    assert tcfg == jcfg and (tfps, tweight) == (jfps, jweight) == (16, 0.2)
    assert tkw.pop("device") == "cpu" and tkw.pop("base_dir") is None
    assert tkw == jkw == {"i2v": False, "dynamic_cfg": True, "lora_weight": 0.2,
                          "absolute_lora": True, "num_frames": 81, "height": 768,
                          "width": 1360}
