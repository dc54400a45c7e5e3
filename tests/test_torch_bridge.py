"""The weight bridge: every leaf of a JAX DiT tree lands in the port's module
and comes back unchanged."""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videogpa_tpu.models.cogvideox import CogVideoXConfig as JaxConfig
from videogpa_tpu.models.cogvideox import dit_init as jax_dit_init
from videogpa_tpu.models.lpips import lpips_init as jax_lpips_init
from videogpa_tpu.models.vggt import VGGTConfig as JaxVGGTConfig
from videogpa_tpu.models.vggt import vggt_init as jax_vggt_init
from videogpa_tpu.models.wan.config import WanConfig as JaxWanConfig
from videogpa_tpu.models.wan.dit import wan_init as jax_wan_init
from videogpa_tpu.ops import layers as JL
from videogpa_torch.convert import load_jax_params, state_dict_from_jax
from videogpa_torch.models.cogvideox import CogVideoXConfig, CogVideoXTransformer
from videogpa_torch.models.lpips import LPIPS
from videogpa_torch.models.vggt import VGGT, VGGTConfig
from videogpa_torch.models.wan import WanConfig, WanTransformer

torch.set_num_threads(2)

_CONFIGS = {
    "tiny": CogVideoXConfig.tiny(),
    "tiny_i2v": CogVideoXConfig.tiny(i2v=True),
    "tiny_pt2_ofs": dataclasses.replace(
        CogVideoXConfig.tiny(), patch_size_t=2, sample_frames=4, ofs_embed_dim=16),
}


def random_jax_tree(init, *args, seed=0):
    """A tree with the exact structure, shapes and dtypes of ``init(key,
    *args)`` (``jax.eval_shape``: nothing is compiled or drawn), filled with
    seeded numpy draws: kernels U(+-1/sqrt(fan_in)), biases U(+-0.1),
    layer-norm scales 1 + U(+-0.1), LayerScale gammas 0.1, every other leaf
    (tokens, tables) N(0, 0.02). JAX's own initialisers take tens of seconds
    on the CPU for a VGGT tree."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda key: init(key, *args), jax.random.PRNGKey(0))

    def fill(path, leaf):
        name, shape = getattr(path[-1], "key", None), leaf.shape
        if name == "kernel":
            bound = float(np.prod(shape[:-1])) ** -0.5
            x = rng.uniform(-bound, bound, shape)
        elif name == "bias":
            x = rng.uniform(-0.1, 0.1, shape)
        elif name == "scale":
            x = 1.0 + rng.uniform(-0.1, 0.1, shape)
        elif name == "gamma":
            x = np.full(shape, 0.1)
        else:
            x = rng.normal(0.0, 0.02, shape)
        return x.astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax_tree(cfg):
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    return jax.tree.map(np.asarray, jax_dit_init(jax.random.PRNGKey(0), jcfg))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, v


def _to_jax_layout(t: np.ndarray, leaf: str) -> np.ndarray:
    if leaf == "kernel" and t.ndim == 2:
        return t.T
    if leaf == "kernel" and t.ndim == 4:
        return t.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    return t


@pytest.mark.parametrize("name", list(_CONFIGS))
def test_every_leaf_round_trips_exactly(name):
    cfg = _CONFIGS[name]
    params = _jax_tree(cfg)
    model = load_jax_params(CogVideoXTransformer(cfg), params)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    used = set()
    for path, leaf in _flat(params):
        module, _, name_ = path.rpartition(".")
        torch_name = {"kernel": "weight", "scale": "weight"}.get(name_, name_)
        if path.startswith("blocks."):
            rest = f"{module[len('blocks.'):]}.{torch_name}"
            keys = [f"blocks.{i}.{rest}" for i in range(cfg.num_layers)]
            back = np.stack([_to_jax_layout(sd[k], name_) for k in keys])
        else:
            keys = [path if not module else f"{module}.{torch_name}"]
            back = _to_jax_layout(sd[keys[0]], name_)
        used.update(keys)
        assert back.dtype == leaf.dtype and back.shape == leaf.shape, path
        np.testing.assert_array_equal(back, leaf, err_msg=path)
    assert used == set(sd), set(sd) ^ used


def test_unmapped_leaf_and_missing_leaf_raise():
    cfg = _CONFIGS["tiny"]
    params = _jax_tree(cfg)
    with pytest.raises(KeyError, match="unmapped"):
        state_dict_from_jax({**params, "extra": {"gamma": np.zeros(3, np.float32)}})
    partial = {k: v for k, v in params.items() if k != "proj_out"}
    with pytest.raises(RuntimeError, match="proj_out"):
        load_jax_params(CogVideoXTransformer(cfg), partial)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys, videogpa_torch\n"
        "for m in pkgutil.walk_packages(videogpa_torch.__path__, 'videogpa_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'videogpa_tpu', 'cv2', 'PIL'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('videogpa_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 12


_STACKED = ("blocks", "frame_blocks", "global_blocks", "trunk")


def _leaves(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            yield from _leaves(v, path)
        else:
            yield path, v


def _rebuilt(sd, path, leaf):
    """(torch keys, the JAX leaf rebuilt from the port's state dict)."""
    *module, name = path.split(".")
    torch_name = {"kernel": "weight", "scale": "weight"}.get(name, name)
    owner = module[-1] if module else ""

    def jax_layout(t):
        if name == "kernel" and t.ndim == 2:
            return t.T
        if name == "kernel" and t.ndim == 4:  # transposed convs: (I, O, k, k) -> (k, k, I, O)
            return t.transpose(2, 3, 0, 1) if owner in ("resize0", "resize1") else \
                t.transpose(2, 3, 1, 0)
        if name == "kernel" and t.ndim == 5:  # (O, I, pt, ph, pw) -> DHWIO
            return t.transpose(2, 3, 4, 1, 0)
        return t

    at = next((i for i, p in enumerate(module) if p in _STACKED), None)
    if at is None:
        key = ".".join(module + [torch_name])
        return [key], jax_layout(sd[key])
    keys = [".".join(module[:at + 1] + [str(i)] + module[at + 1:] + [torch_name])
            for i in range(leaf.shape[0])]
    return keys, np.stack([jax_layout(sd[k]) for k in keys])


@pytest.mark.parametrize("name", ["vggt_tiny", "lpips"])
def test_vggt_and_lpips_trees_round_trip_strictly(name):
    """Stacked blocks (DINOv2, frame/global, camera trunk), list leaves
    (projects, layer_rn, convs, lins), verbatim tokens and LayerScale gammas,
    and the DPT's transposed convs all land and come back unchanged."""
    if name == "vggt_tiny":
        params = random_jax_tree(jax_vggt_init, JaxVGGTConfig.tiny())
        make = lambda: VGGT(VGGTConfig.tiny())  # noqa: E731
    else:
        params = random_jax_tree(jax_lpips_init, seed=1)
        make = LPIPS
    model = load_jax_params(make(), params)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    used = set()
    for path, leaf in _leaves(params):
        keys, back = _rebuilt(sd, path, leaf)
        used.update(keys)
        assert back.dtype == leaf.dtype and back.shape == leaf.shape, path
        np.testing.assert_array_equal(back, leaf, err_msg=path)
    assert used == set(sd), set(sd) ^ used
    partial = dict(params)
    partial.pop(next(iter(partial)))
    with pytest.raises(RuntimeError):  # strict: a missing node fails the load
        load_jax_params(make(), partial)


def test_transposed_conv_layout_is_unflipped_in_out():
    """JAX keeps ``resize0``/``resize1`` HWIO (k, k, in, out) and applies them
    as an einsum; ``nn.ConvTranspose2d(stride=k)`` wants (in, out, k, k),
    unflipped -- not the OIHW of an ordinary conv."""
    params = random_jax_tree(jax_vggt_init, JaxVGGTConfig.tiny())
    head = load_jax_params(VGGT(VGGTConfig.tiny()), params).depth_head
    for name, k in (("resize0", 4), ("resize1", 2)):
        kernel = params["depth_head"][name]["kernel"]
        w = getattr(head, name).weight.detach().numpy()
        np.testing.assert_array_equal(w, kernel.transpose(2, 3, 0, 1))
        x = np.random.default_rng(k).standard_normal((1, kernel.shape[2], 3, 5), dtype=np.float32)
        want = JL.conv_transpose2d(params["depth_head"][name], jnp.asarray(x), stride=k)
        with torch.no_grad():
            got = getattr(head, name)(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("init", ["jax_init", "random_tree"])
def test_wan_tree_round_trips_strictly(init):
    """``wan_init(WanConfig.tiny())``: stacked blocks, the 5-D patch-embed
    kernel, RMS-norm scales and the (1, 6, d) / (1, 2, d) modulations all land
    and come back unchanged; loading is strict."""
    cfg, jcfg = WanConfig.tiny(), JaxWanConfig.tiny()
    if init == "jax_init":
        params = jax.tree.map(np.asarray, jax_wan_init(jax.random.PRNGKey(0), jcfg))
    else:
        params = random_jax_tree(jax_wan_init, jcfg, seed=2)
    model = load_jax_params(WanTransformer(cfg), params)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    used = set()
    for path, leaf in _leaves(params):
        keys, back = _rebuilt(sd, path, leaf)
        used.update(keys)
        assert back.dtype == leaf.dtype and back.shape == leaf.shape, path
        np.testing.assert_array_equal(back, leaf, err_msg=path)
    assert used == set(sd), set(sd) ^ used
    partial = {k: v for k, v in params.items() if k != "head"}
    with pytest.raises(RuntimeError, match="head"):
        load_jax_params(WanTransformer(cfg), partial)


def test_wan_patch_kernel_and_modulation_land_where_stated():
    cfg, jcfg = WanConfig.tiny(), JaxWanConfig.tiny()
    params = random_jax_tree(jax_wan_init, jcfg, seed=4)
    model = load_jax_params(WanTransformer(cfg), params)
    kernel = params["patch_embedding"]["kernel"]  # DHWIO (pt, ph, pw, in, d)
    pt, ph, pw = cfg.patch_size
    assert kernel.shape == (pt, ph, pw, cfg.in_channels, cfg.dim)
    w = model.patch_embedding.weight.detach().numpy()
    assert w.shape == (cfg.dim, cfg.in_channels, pt, ph, pw)
    np.testing.assert_array_equal(w, kernel.transpose(4, 3, 0, 1, 2))
    for i, blk in enumerate(model.blocks):
        assert blk.modulation.shape == (1, 6, cfg.dim)
        np.testing.assert_array_equal(blk.modulation.detach().numpy(),
                                      params["blocks"]["modulation"][i])
        np.testing.assert_array_equal(blk.self_attn.norm_q.weight.detach().numpy(),
                                      params["blocks"]["self_attn"]["norm_q"]["scale"][i])
    np.testing.assert_array_equal(model.head.modulation.detach().numpy(),
                                  params["head"]["modulation"])
    # the patch embed as the port computes it is JAX's strided conv: tokens in
    # (f, h, w) order
    x = np.random.default_rng(5).standard_normal((1, cfg.in_channels, 2, 4, 6), dtype=np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(kernel), window_strides=cfg.patch_size, padding="VALID",
        dimension_numbers=("NCDHW", "DHWIO", "NCDHW"))
    want = np.asarray(want + params["patch_embedding"]["bias"][None, :, None, None, None])
    with torch.no_grad():
        got = model.patch_embedding(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want.reshape(1, cfg.dim, -1).transpose(0, 2, 1),
                               atol=1e-5, rtol=1e-5)
