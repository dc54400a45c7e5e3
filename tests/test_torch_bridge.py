"""The weight bridge: every leaf of a JAX DiT tree lands in the port's module
and comes back unchanged."""

import dataclasses
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from videogpa_tpu.models.cogvideox import CogVideoXConfig as JaxConfig
from videogpa_tpu.models.cogvideox import dit_init as jax_dit_init
from videogpa_torch.convert import load_jax_params, state_dict_from_jax
from videogpa_torch.models.cogvideox import CogVideoXConfig, CogVideoXTransformer

torch.set_num_threads(2)

_CONFIGS = {
    "tiny": CogVideoXConfig.tiny(),
    "tiny_i2v": CogVideoXConfig.tiny(i2v=True),
    "tiny_pt2_ofs": dataclasses.replace(
        CogVideoXConfig.tiny(), patch_size_t=2, sample_frames=4, ofs_embed_dim=16),
}


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
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'videogpa_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('videogpa_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 12
