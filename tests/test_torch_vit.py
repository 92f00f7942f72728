"""The port's ViT classifier against the JAX package's, on the CPU.

The flax ViT's params go through ``from_jax_params`` into the port, and the
same numpy images go through both; fp32 compute on both sides.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("flax")  # the JAX reference; the card's machine lacks it

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models.vit import VIT_CONFIGS as JAX_VIT_CONFIGS
from ray_tpu.models.vit import VisionTransformer as JaxViT
from ray_tpu.models.vit import accuracy as jax_accuracy
from ray_tpu.models.vit import classification_loss as jax_classification_loss
from ray_tpu_torch.models import (VIT_CONFIGS, VisionTransformer, accuracy,
                                  classification_loss, from_jax_params,
                                  init_params)
from ray_tpu_torch.models.convert import check_params
from ray_tpu_torch.models.vit import attention_route, state_dict_shapes
from ray_tpu_torch.parallel import make_optimizer

# fp32, the same products summed in other orders (the dense LM's parity,
# tests/test_torch_model.py): logits and grads of order 1 to 1e-5, the
# pos_embed and cls_token grads (sums over the batch, ~10) to 1e-4 of size
FP32_TOL = dict(atol=1e-5, rtol=1e-4)
# the reduced config of tests/test_moe_vit.py's training test
REDUCED = dict(num_classes=4, n_layers=2, d_model=64, d_ff=128)


def _configs(n_heads):
    kw = dict(REDUCED, n_heads=n_heads)
    return (dataclasses.replace(JAX_VIT_CONFIGS["vit-tiny"], dtype=jnp.float32,
                                **kw),
            dataclasses.replace(VIT_CONFIGS["vit-tiny"], dtype=torch.float32,
                                **kw))


def _unbox(tree):
    return jax.tree_util.tree_map(np.asarray, fnn.meta.unbox(tree))


def _flat_keys(tree):
    return {".".join(p.key for p in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("n_heads", [4, 1], ids=["hd16_plain", "hd64_flash"])
def test_vit_logits_and_grads_match_jax(n_heads):
    """fp32 logits and the grads of ``classification_loss`` with respect to
    every weight, against the JAX ViT. At head_dim 16 the port's attention
    is plain (``xla``); at 64 it is ``FlashAttention`` (its plain forward
    and backward on the CPU)."""
    jcfg, tcfg = _configs(n_heads)
    assert attention_route(tcfg) == ("xla" if n_heads == 4 else "auto")
    rng = np.random.default_rng(n_heads)
    images = rng.normal(0, 1, (3, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 4, 3).astype(np.int32)
    jmodel = JaxViT(jcfg)
    params = _unbox(jmodel.init(jax.random.PRNGKey(0),
                                jnp.asarray(images)))["params"]

    def jax_loss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(images))
        return jax_classification_loss(logits, jnp.asarray(labels)), logits

    (_, want_logits), want_grads = jax.value_and_grad(
        jax_loss, has_aux=True)(params)
    model = VisionTransformer(tcfg, device="cpu",
                              params=from_jax_params(params))
    logits = model(torch.from_numpy(images))
    assert logits.dtype == torch.float32 and logits.shape == (3, 4)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), **FP32_TOL)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(
        classification_loss(logits, torch.from_numpy(labels)),
        list(model.parameters()))
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, want_grads))
    assert set(names) == set(want)
    for name, got in zip(names, grads):
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   err_msg=name, **FP32_TOL)


def test_classification_loss_and_accuracy_match_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((16, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 16).astype(np.int32)
    labels[:6] = logits[:6].argmax(-1)  # some right, to make accuracy > 0
    want_loss = jax_classification_loss(jnp.asarray(logits),
                                        jnp.asarray(labels))
    want_acc = jax_accuracy(jnp.asarray(logits), jnp.asarray(labels))
    t_logits, t_labels = torch.from_numpy(logits), torch.from_numpy(labels)
    np.testing.assert_allclose(
        classification_loss(t_logits, t_labels).item(), float(want_loss),
        rtol=1e-6)
    assert accuracy(t_logits, t_labels).item() == pytest.approx(
        float(want_acc))


@pytest.mark.parametrize("name", ["vit-tiny", "vit-b16-224"])
def test_vit_shapes_match_flax(name):
    """The flax tree's paths and shapes (vit-b16-224 by shape only, through
    ``jax.eval_shape``) are the port's."""
    jcfg = JAX_VIT_CONFIGS[name]
    images = jnp.zeros((1, jcfg.image_size, jcfg.image_size, 3))
    abstract = jax.eval_shape(lambda: fnn.meta.unbox(
        JaxViT(jcfg).init(jax.random.PRNGKey(0), images)))
    want = {k: v.shape for k, v in _flat_keys(abstract["params"]).items()}
    assert want == state_dict_shapes(VIT_CONFIGS[name])


def test_vit_params_convert_leaf_for_leaf():
    """``from_jax_params`` copies every leaf of a flax ViT tree, and the
    model loads them with no key left over."""
    cfg = VIT_CONFIGS["vit-tiny"]
    tree = _unbox(JaxViT(JAX_VIT_CONFIGS["vit-tiny"]).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    sd = from_jax_params(tree)
    flat = _flat_keys(tree["params"])
    assert set(sd) == set(flat)
    for key, leaf in flat.items():
        np.testing.assert_array_equal(sd[key].numpy(), leaf)
    check_params(sd, cfg)
    model = VisionTransformer(cfg, device="cpu", params=sd)
    assert set(model.state_dict()) == set(sd)


def test_vit_init_params_follow_flax_laws():
    """lecun_normal (a truncated normal of std sqrt(1 / fan_in)) for the
    patch embedding, the attention projections and the head; xavier_uniform
    for the MLP; normal(0.02) for pos_embed; zeros and ones elsewhere."""
    cfg = VIT_CONFIGS["vit-s16-224"]
    p = init_params(cfg, seed=0, device="cpu")
    check_params(p, cfg)
    d, f = cfg.d_model, cfg.d_ff
    for key, fan_in in (("patch_embed.kernel", 16 * 16 * 3),
                        ("block_0.attn.query.kernel", d),
                        ("block_0.attn.out.kernel", d),
                        ("head.kernel", d)):
        std = p[key].std().item()
        assert abs(std - fan_in ** -0.5) < 0.05 * fan_in ** -0.5, key
        assert p[key].abs().max().item() <= 2 * fan_in ** -0.5 / 0.8796 + 1e-6
    limit = (6.0 / (d + f)) ** 0.5
    assert p["block_0.fc1.kernel"].abs().max().item() <= limit
    assert abs(p["block_0.fc1.kernel"].std().item() - limit / 3 ** 0.5) \
        < 0.05 * limit
    assert abs(p["pos_embed"].std().item() - 0.02) < 0.002
    for key in ("cls_token", "block_0.attn.key.bias", "head.bias",
                "block_0.ln1.bias"):
        assert not p[key].any(), key
    assert bool((p["ln_final.scale"] == 1).all())


def test_attention_route_is_fixed_by_the_head_dim():
    """vit-tiny (head_dim 32) takes plain attention; vit-s16 and vit-b16
    (64) take the flash kernels; asking for the kernels at 32 raises when
    the model is built, not when it runs."""
    assert VIT_CONFIGS["vit-tiny"].head_dim == 32
    assert attention_route(VIT_CONFIGS["vit-tiny"]) == "xla"
    for name in ("vit-s16-224", "vit-b16-224"):
        assert VIT_CONFIGS[name].head_dim == 64
        assert attention_route(VIT_CONFIGS[name]) == "auto"
    small = dataclasses.replace(VIT_CONFIGS["vit-tiny"], n_layers=1)
    assert VisionTransformer(small, device="cpu").block_0.attn.impl == "xla"
    with pytest.raises(ValueError, match="head_dim"):
        VisionTransformer(dataclasses.replace(small, attention_impl="flash"),
                          device="cpu")
    plain = dataclasses.replace(VIT_CONFIGS["vit-b16-224"],
                                attention_impl="xla")
    assert attention_route(plain) == "xla"


def test_vit_learns_the_quadrant_task():
    """Mirror of tests/test_moe_vit.py's ViT test: the reduced ViT overfits
    one batch of the brightest-quadrant task (4 classes) with Adam at 1e-3
    (the port's optimizer without decay, clip or schedule)."""
    rng = np.random.default_rng(0)
    images = rng.normal(0, 0.3, (32, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 4, 32)
    for i, lab in enumerate(labels):
        y0, x0 = (lab // 2) * 16, (lab % 2) * 16
        images[i, y0:y0 + 16, x0:x0 + 16] += 2.0
    cfg = dataclasses.replace(VIT_CONFIGS["vit-tiny"], n_heads=4, **REDUCED)
    model = VisionTransformer(cfg, device="cpu", seed=0)
    params = dict(model.named_parameters())
    opt = make_optimizer(learning_rate=1e-3, weight_decay=0.0,
                         warmup_steps=0, total_steps=10 ** 9, b2=0.999,
                         clip=1e9)
    state = opt.init(params)
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    accs = []
    for _ in range(60):
        logits = model(x)
        loss = classification_loss(logits, y)
        opt.update(params, torch.autograd.grad(loss, list(params.values())),
                   state)
        accs.append(accuracy(logits, y).item())
    assert np.mean(accs[-5:]) > 0.9, f"ViT failed to learn: {accs[-5:]}"
