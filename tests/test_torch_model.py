"""The port's decoder LM against the JAX package's flax model, on the CPU.

The flax model is initialised once; its params go through
``from_jax_params`` into the port, and the same numpy tokens go through
both forwards.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("flax")  # the JAX reference; the card's machine lacks it

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models.transformer import CONFIGS as JAX_CONFIGS
from ray_tpu.models.transformer import Transformer as JaxTransformer
from ray_tpu.models.transformer import lm_loss as jax_lm_loss
from ray_tpu_torch.models import CONFIGS, Transformer, from_jax_params, init_params, lm_loss
from ray_tpu_torch.models.transformer import state_dict_shapes

# fp32: the two frameworks sum the same fp32 products in other orders
FP32_TOL = dict(atol=1e-5, rtol=1e-4)
# bf16: activations are rounded to bf16 (8 mantissa bits, an ulp of 4e-3
# at |x| ~ 1) after every product in both, at slightly different points;
# the logits are below 1, so a few ulps
BF16_TOL = dict(atol=1e-2, rtol=2e-2)


@pytest.fixture(scope="module")
def jax_params():
    cfg = JAX_CONFIGS["tiny"]
    toks = jnp.zeros((1, 8), jnp.int32)
    tree = fnn.meta.unbox(JaxTransformer(cfg).init(jax.random.PRNGKey(0), toks))
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(seed=0, B=2, S=24):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_logits_match_flax(jax_params, dtype):
    jcfg = dataclasses.replace(JAX_CONFIGS["tiny"], dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(CONFIGS["tiny"], dtype=getattr(torch, dtype))
    toks = _tokens()
    want = JaxTransformer(jcfg).apply(jax_params, jnp.asarray(toks))
    model = Transformer(tcfg, device="cpu", params=from_jax_params(jax_params))
    with torch.no_grad():
        got = model(torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and got.shape == (2, 24, 256)
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), **tol)


def test_head_dim_64_goes_through_flash_path():
    """At head_dim 64 the port's attention takes the flash forward (its
    plain version on the CPU); the JAX side runs its Pallas kernel in
    interpret mode. 2 layers, 2 query heads over 1 KV head, fp32."""
    shape = dict(d_model=128, n_heads=2, n_kv_heads=1, dtype=jnp.float32)
    jcfg = dataclasses.replace(JAX_CONFIGS["tiny"], attention_impl="flash_interpret",
                               **shape)
    toks = _tokens(S=32)
    tree = fnn.meta.unbox(JaxTransformer(jcfg).init(jax.random.PRNGKey(1),
                                                    jnp.asarray(toks)))
    want = JaxTransformer(jcfg).apply(tree, jnp.asarray(toks))
    tcfg = dataclasses.replace(CONFIGS["tiny"], **{**shape, "dtype": torch.float32})
    assert tcfg.head_dim == 64
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, tree))
    with torch.no_grad():
        got = Transformer(tcfg, device="cpu", params=params)(
            torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


def test_lm_loss_matches_flax(jax_params):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 24, 256)).astype(np.float32)
    targets = rng.integers(0, 256, (2, 24)).astype(np.int32)
    mask = (rng.random((2, 24)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = jax_lm_loss(jnp.asarray(logits), jnp.asarray(targets),
                           None if m is None else jnp.asarray(m))
        got = lm_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                      None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_from_jax_params_covers_every_leaf(jax_params):
    sd = from_jax_params(jax_params)
    leaves = jax.tree_util.tree_leaves_with_path(jax_params["params"])
    assert len(sd) == len(leaves)
    for path, leaf in leaves:
        key = ".".join(p.key for p in path)
        assert tuple(sd[key].shape) == leaf.shape
        np.testing.assert_array_equal(sd[key].numpy(), leaf)
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        state_dict_shapes(CONFIGS["tiny"])
    model = Transformer(CONFIGS["tiny"], device="cpu", params=sd)
    assert set(model.state_dict()) == set(sd)


@pytest.mark.parametrize("name", sorted(JAX_CONFIGS))
def test_config_accounting_matches_jax(name):
    j, t = JAX_CONFIGS[name], CONFIGS[name]
    assert t.head_dim == j.head_dim
    assert t.num_params() == j.num_params()
    assert t.active_params() == j.active_params()
    assert t.flops_per_token() == j.flops_per_token()


def test_init_params_seeded_with_flax_laws():
    cfg = CONFIGS["tiny"]
    a = init_params(cfg, seed=3, device="cpu")
    b = init_params(cfg, seed=3, device="cpu")
    c = init_params(cfg, seed=4, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    assert torch.equal(a["final_norm.scale"], torch.ones(cfg.d_model))
    proj_std = 0.02 / np.sqrt(2 * cfg.n_layers)
    assert abs(a["embed"].std().item() - 0.02) < 0.002
    assert abs(a["layer_0.mlp.up_proj.kernel"].std().item() - proj_std) \
        < 0.1 * proj_std
    assert a["layer_0.attn.q_proj.kernel"].dtype == cfg.param_dtype


def test_moe_config_raises():
    """MoE configs build and train in the port (tests/test_torch_moe.py),
    but the engine serves dense models only, as the JAX engine does: it
    refuses a MoE config before drawing any weight."""
    from ray_tpu_torch.llm.config import LLMConfig
    from ray_tpu_torch.llm.engine import TorchLLMEngine

    with pytest.raises(NotImplementedError, match="dense models only"):
        TorchLLMEngine(LLMConfig(model_id="moe-tiny"), device="cpu")
