"""PyTorch port: vocabulary remapping (``vocab_remap.py``) against the JAX
package's, and the port's LM against HF transformers' Gemma-3 (CPU).

The remap: JAX's reference-checkpoint case (``tests/test_torch_interop.py``)
and a random one with truncated, out-of-range and destination-only ids,
numpy and tensor tables: the same table and copy count as JAX's, bitwise;
a state dict without the table raises ``KeyError``.  The LM: a randomly
initialised, perturbed HF ``Gemma3TextModel`` (``tests/test_gemma3_parity.py``'s
toy config: 7 layers, one of them global, dual rope bases, q/k norms,
sandwich norms, ``query_pre_attn_scalar``) loaded ``strict=True`` into the
port's ``CausalLM`` under ``model.``; final hidden states within 2e-5 abs
(rtol 1e-4), float32, as the JAX test holds JAX's.  transformers is needed
for that case only.
"""

import numpy as np
import pytest
import torch


def _interop_case():
    rng = np.random.default_rng(0)
    src_vocab = {"<pad>": 0, "Yes": 7, "No": 3, "red": 11, "<ood 1>": 12, "blue": 5}
    sd = {"language_model.model.embed_tokens.weight": rng.normal(size=(16, 4)).astype(np.float32),
          "projector.weight": rng.normal(size=(4, 4)).astype(np.float32)}
    dst_vocab = {"<pad>": 0, "No": 1, "Yes": 2, "red": 3, "blue": 4, "<ood 1>": 5, "green": 6}
    return sd, src_vocab, dst_vocab, np.zeros((8, 4), np.float32)


def _random_case():
    rng = np.random.default_rng(1)
    tokens = [f"tok{i}" for i in range(60)]
    src_vocab = {t: int(i) for t, i in zip(tokens[:50], rng.permutation(50) + 3)}  # ids up to 52
    dst_vocab = {t: int(i) for t, i in zip(tokens[10:], rng.permutation(50))}
    sd = {"language_model.model.embed_tokens.weight": rng.normal(size=(48, 6)).astype(np.float32),
          "vision_model.x": rng.normal(size=(2, 2)).astype(np.float32)}
    return sd, src_vocab, dst_vocab, rng.normal(size=(40, 6)).astype(np.float32)


@pytest.mark.parametrize("case", [_interop_case, _random_case])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_remap_matches_jax(case, as_tensor):
    from multimodal_concept_learning_tpu.checkpoint.vocab_remap import (
        remap_state_dict_vocab as jremap,
    )
    from multimodal_concept_learning_tpu_torch.vocab_remap import EMBED_KEY, remap_state_dict_vocab

    sd, src_vocab, dst_vocab, template = case()
    want, want_copied = jremap(sd, src_vocab, dst_vocab, template)
    if as_tensor:
        sd = {k: torch.from_numpy(v) for k, v in sd.items()}
        template = torch.from_numpy(template)
    got, copied = remap_state_dict_vocab(sd, src_vocab, dst_vocab, template)
    assert copied == want_copied and sorted(got) == sorted(want)
    assert isinstance(got[EMBED_KEY], torch.Tensor) == as_tensor
    for key, value in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), value, err_msg=key)
    assert got[EMBED_KEY] is not template and got[EMBED_KEY] is not sd[EMBED_KEY]
    if case is _interop_case:
        assert copied == 6


def test_remap_without_table_raises_key_error():
    from multimodal_concept_learning_tpu_torch.vocab_remap import remap_state_dict_vocab

    with pytest.raises(KeyError, match="embed_tokens"):
        remap_state_dict_vocab({"projector.weight": np.zeros((2, 2))}, {}, {}, np.zeros((2, 2)))


def test_lm_matches_hf_gemma3():
    transformers = pytest.importorskip("transformers")
    from transformers.models.gemma3.modeling_gemma3 import Gemma3TextModel

    from multimodal_concept_learning_tpu_torch.models.lm import CausalLM, LMConfig

    vocab = 256
    hf_cfg = transformers.Gemma3TextConfig(
        vocab_size=vocab, hidden_size=64, intermediate_size=128, num_hidden_layers=7,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, sliding_window=8,
        rope_theta=1_000_000.0, rope_local_base_freq=10_000.0, query_pre_attn_scalar=16,
        max_position_embeddings=64, attn_implementation="eager")
    torch.manual_seed(0)
    hf = Gemma3TextModel(hf_cfg).eval().float()
    with torch.no_grad():
        for p in hf.parameters():
            p.add_(0.05 * torch.randn_like(p))
    cfg = LMConfig(vocab_size=vocab, hidden_size=64, intermediate_size=128, num_layers=7,
                   num_heads=4, num_kv_heads=2, head_dim=16, rope_theta=1_000_000.0,
                   rope_local_theta=10_000.0, use_qk_norm=True, sandwich_norms=True,
                   sliding_window=8, sliding_window_pattern=6, query_pre_attn_scalar=16.0,
                   dtype=torch.float32)
    assert [cfg.layer_is_sliding(i) for i in range(7)] == [True] * 5 + [False, True]
    port = CausalLM(cfg)
    port.load_state_dict({f"model.{k}": v for k, v in hf.state_dict().items()}, strict=True)
    port.eval()
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, vocab, size=(2, 24)))
    with torch.no_grad():
        want = hf(input_ids=ids, attention_mask=torch.ones(2, 24, dtype=torch.long)
                  ).last_hidden_state
        got = port.hidden_states(port.embed(ids), torch.ones(2, 24, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=1e-4)
