"""PyTorch port: the sharding rules' spec table, the hybrid mesh's shape
logic and the scanned-layer checkpoint conversion, in one process.

- ``param_shardings`` of the port's MLLM (float, int8, LoRA, MoE), CLIP
  and classifier equals JAX ``mllm_param_spec`` for every leaf (on JAX's
  virtual devices), the leaf mapped onto its port name by the port's own
  converter, on (4 data x 2 model), (2, 2), 1-D FSDP over 8 data ranks and
  the hybrid (2 replica x 2 data x 2 model) meshes, with and without
  FSDP; no parameter is ever sharded over the replica axis.
- ``hybrid_mesh_shape`` / ``dp_axes``: shapes, axes and the
  too-few-ranks error of JAX ``make_hybrid_mesh``.
- ``state_dict_from_jax`` unstacks a ``scan_lm_layers=True`` tree: the
  port loads it with ``strict=True`` and matches JAX's hidden states
  within 1e-4.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _torch_parity as tp

MESHES = {  # name: ({axis: size}, fsdp_axis)
    "4x2": ({"data": 4, "model": 2}, None),
    "4x2_fsdp": ({"data": 4, "model": 2}, "data"),
    "2x2_fsdp": ({"data": 2, "model": 2}, "data"),
    "fsdp8": ({"data": 8}, "data"),
    "hybrid_fsdp": ({"replica": 2, "data": 2, "model": 2}, "data"),
}


def _jax_mesh(sizes):
    devices = np.asarray(jax.devices()[:int(np.prod(list(sizes.values())))])
    return Mesh(devices.reshape(tuple(sizes.values())), tuple(sizes))


def _mllm_tree(**lm):
    from multimodal_concept_learning_tpu.models import MLLM, LMConfig, MLLMConfig, ViTConfig

    vision = ViTConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                       num_attention_heads=4, patch_size=8, image_size=32, num_labels=0,
                       dtype=jnp.float32)
    cfg = MLLMConfig(vision=vision, lm=dataclasses.replace(
        LMConfig.preset("nano", vocab_size=256), dtype=jnp.float32, **lm),
        num_vision_tokens=17, max_answer_tokens=4, dtype=jnp.float32)
    model = MLLM(cfg)
    ids = jnp.zeros((1, 21), jnp.int32)
    params = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 3, 32, 32)), ids,
                                 jnp.ones_like(ids))["params"]
    return cfg, params


def _models():
    """{name: (JAX leaf tree, converter(tree) -> port state dict, port module on meta)}."""
    from multimodal_concept_learning_tpu.models.clip import CLIPConfig as JCLIPConfig
    from multimodal_concept_learning_tpu.models.clip import CLIPModel as JCLIP
    from multimodal_concept_learning_tpu.models.vit import ViTConfig as JViT
    from multimodal_concept_learning_tpu.models.vit import ViTForImageClassification as JClf
    from multimodal_concept_learning_tpu.ops.quant import quantize_mllm_params
    from multimodal_concept_learning_tpu_torch.checkpoint import (
        clip_state_dict_from_jax,
        state_dict_from_jax,
        vit_classifier_state_dict_from_jax,
    )
    from multimodal_concept_learning_tpu_torch.models.clip import CLIPConfig, CLIPModel
    from multimodal_concept_learning_tpu_torch.models.mllm import MLLM
    from multimodal_concept_learning_tpu_torch.models.vit import (
        ViTConfig,
        ViTForImageClassification,
    )
    from multimodal_concept_learning_tpu_torch.tokenizer import ConceptTokenizer

    def meta(cls, cfg):
        with torch.device("meta"):
            return cls(cfg)

    out = {}
    mllm_conv = lambda t: state_dict_from_jax(t, 8)  # noqa: E731
    for name, lm in (("mllm", {}), ("lora", dict(lora_rank=4)),
                     ("moe", dict(moe_experts=4, moe_top_k=2))):
        cfg, params = _mllm_tree(**lm)
        out[name] = (params, mllm_conv, meta(MLLM, tp.port_config(cfg)))
    cfg, params = _mllm_tree()
    qcfg = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, int8_weights=True),
                               vision=dataclasses.replace(cfg.vision, int8_weights=True))
    qparams = quantize_mllm_params(jax.tree_util.tree_map(np.asarray, params), cfg)
    out["int8"] = (qparams, mllm_conv, meta(MLLM, tp.port_config(qcfg)))

    vocab = len(ConceptTokenizer())
    clip = dict(image_size=32, text_width=32, text_layers=1, text_heads=2, context_length=16,
                embed_dim=16)
    jcfg = JCLIPConfig.create(vocab_size=vocab, vision_preset="vit-t-8", **clip)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32,
                               vision=dataclasses.replace(jcfg.vision, dtype=jnp.float32))
    cparams = jax.jit(JCLIP(jcfg).init)(jax.random.key(2), jnp.zeros((1, 3, 32, 32)),
                                        jnp.zeros((1, 16), jnp.int32),
                                        jnp.ones((1, 16), jnp.int32))["params"]
    pcfg = CLIPConfig.create(vocab_size=vocab, vision_preset="vit-t-8", dtype=torch.float32,
                             **clip)
    out["clip"] = (cparams, lambda t: clip_state_dict_from_jax(t, 8), meta(CLIPModel, pcfg))

    vit = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, patch_size=8, image_size=32, num_labels=4)
    vparams = jax.jit(JClf(JViT(**vit, dtype=jnp.float32)).init)(
        jax.random.key(1), jnp.zeros((1, 3, 32, 32)))["params"]
    out["classifier"] = (vparams, lambda t: vit_classifier_state_dict_from_jax(t, 8),
                         meta(ViTForImageClassification, ViTConfig(**vit, dtype=torch.float32)))
    return out


@pytest.fixture(scope="module")
def models():
    return _models()


def _nest(path, leaf):
    """A tree holding one leaf at ``path``."""
    node = leaf
    for key in reversed(path):
        node = {key: node}
    return node


def _port_name(convert, path, leaf):
    names = list(convert(_nest(path, np.asarray(leaf))))
    assert len(names) == 1, (path, names)
    return names[0]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("model_name", ["mllm", "int8", "lora", "moe", "clip", "classifier"])
def test_spec_table_equals_jax(models, model_name, mesh_name):
    from multimodal_concept_learning_tpu.parallel.sharding_rules import mllm_param_spec
    from multimodal_concept_learning_tpu_torch.parallel.sharding_rules import param_shardings

    sizes, fsdp = MESHES[mesh_name]
    params, convert, port_model = models[model_name]
    table = param_shardings(port_model, sizes, fsdp_axis=fsdp)
    mesh = _jax_mesh(sizes)
    seen = set()
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        keys = tuple(getattr(p, "key", getattr(p, "name", str(p))) for p in path)
        want = tuple(mllm_param_spec(path, leaf, mesh, fsdp_axis=fsdp))
        want = want + (None,) * (np.ndim(leaf) - len(want))
        name = _port_name(convert, keys, leaf)
        assert table[name] == want, (model_name, mesh_name, keys, name, table[name], want)
        seen.add(name)
    assert seen == set(table)  # every port tensor is some JAX leaf


def test_sharding_actually_splits_things(models):
    from multimodal_concept_learning_tpu_torch.parallel.sharding_rules import param_shardings

    table = param_shardings(models["moe"][2], {"data": 2, "model": 2})
    assert table["language_model.model.layers.0.moe.experts_gate"] == ("model", None, None)
    table = param_shardings(models["mllm"][2], {"data": 2, "model": 2}, fsdp_axis="data")
    # q [H, heads, hd]: heads over model, then H (the largest left) over data
    assert table["language_model.model.layers.0.self_attn.q_proj.weight"] == (
        "data", "model", None)
    from multimodal_concept_learning_tpu_torch.parallel.sharding_rules import mllm_param_spec

    q = torch.empty(4 * 32, 128, device="meta")  # nano: 4 heads of 32 over hidden 128
    assert mllm_param_spec("language_model.model.layers.0.self_attn.q_proj.weight", q,
                           {"data": 2, "model": 2}, fsdp_axis="data", heads=4) == (
        "data", "model", None)
    assert table["language_model.model.embed_tokens.weight"] == (("model", "data"), None)
    table = param_shardings(models["int8"][2], {"data": 2, "model": 2})
    assert table["language_model.model.layers.0.self_attn.q_proj.kernel"] == (None, "model")
    assert table["language_model.model.layers.0.self_attn.q_proj.scale"] == (None,)


def test_params_never_sharded_over_replica(models):
    from multimodal_concept_learning_tpu_torch.parallel.sharding_rules import param_shardings

    sizes = {"replica": 2, "data": 2, "model": 2}
    for name, (_, _, module) in models.items():
        for spec in param_shardings(module, sizes, fsdp_axis="data").values():
            for dim in spec:
                assert "replica" not in ((dim,) if isinstance(dim, str) else (dim or ())), name


def test_hybrid_mesh_shape_axes_and_error():
    from multimodal_concept_learning_tpu_torch.parallel.multihost import (
        dp_axes,
        hybrid_mesh_shape,
    )

    shape, names = hybrid_mesh_shape((2, 2), ("data", "model"), 2, "replica", 8)
    assert shape == (2, 2, 2) and names == ("replica", "data", "model")
    assert hybrid_mesh_shape((2, 2), ("data", "model"), None, "replica", 8)[0] == (2, 2, 2)
    with pytest.raises(ValueError, match="devices"):
        hybrid_mesh_shape((4, 2), ("data", "model"), 4, "replica", 8)
    with pytest.raises(ValueError, match="axis_names"):
        hybrid_mesh_shape((2, 2), ("data",), 2, "replica", 8)
    mesh = types.SimpleNamespace(mesh_dim_names=("replica", "data", "model"))
    assert dp_axes(mesh) == ("replica", "data")
    assert dp_axes(types.SimpleNamespace(mesh_dim_names=("data",))) == ("data",)
    with pytest.raises(ValueError, match="no data-parallel axis"):
        dp_axes(types.SimpleNamespace(mesh_dim_names=("model",)))


def test_scanned_tree_converts_and_matches_jax():
    """A ``scan_lm_layers=True`` JAX tree (layers stacked under
    ``layers_scan/block``) unstacks into the port's per-layer names."""
    from multimodal_concept_learning_tpu.models.mllm import MLLM, MLLMConfig
    from multimodal_concept_learning_tpu_torch.checkpoint import state_dict_from_jax
    from multimodal_concept_learning_tpu_torch.models.mllm import MLLM as PortMLLM

    jcfg = MLLMConfig.create(vocab_size=64, vision_preset="vit-t-8", lm_preset="nano",
                             num_vision_tokens=17, image_size=32, scan_lm_layers=True)
    jcfg = dataclasses.replace(
        jcfg, dtype=jnp.float32, vision=dataclasses.replace(jcfg.vision, dtype=jnp.float32),
        lm=dataclasses.replace(jcfg.lm, dtype=jnp.float32, **tp.GEMMA_SMALL))
    model = MLLM(jcfg)
    images, ids, mask = tp.prompt_batch(jcfg, [5, 2, 7], seed=4)
    params = jax.jit(model.init)(jax.random.key(0), images, ids, mask)["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) + 0.05 * rng.standard_normal(x.shape).astype(
            np.float32), params)
    assert "layers_scan" in params["language_model"]
    port = PortMLLM(tp.port_config(jcfg))
    port.load_state_dict(state_dict_from_jax(params, 8), strict=True)
    want = np.asarray(model.apply({"params": params}, images, ids, mask)["hidden_states"])
    with torch.no_grad():
        got = port(torch.as_tensor(images), torch.as_tensor(ids),
                   torch.as_tensor(mask))["hidden_states"].numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_init_distributed_backend_is_explicit():
    """Gloo on the card is asked for, never a fallback; NCCL needs the card."""
    from multimodal_concept_learning_tpu_torch.parallel.multihost import init_distributed

    with pytest.raises(ValueError, match="backend must be"):
        init_distributed("cpu", init_method="tcp://localhost:1", world_size=1, rank=0,
                         backend="mpi")
    with pytest.raises(ValueError, match="NCCL backend needs"):
        init_distributed("cpu", init_method="tcp://localhost:1", world_size=1, rank=0,
                         backend="nccl")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="without a CUDA device"):
            init_distributed("cuda", init_method="tcp://localhost:1", world_size=2, rank=0,
                             backend="gloo", device_index=0)
