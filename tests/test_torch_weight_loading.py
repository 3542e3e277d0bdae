"""The port's converted models against random-weight ``transformers``
models (HF ``CLIPModel`` and ``Qwen2ForCausalLM``), built offline here as
tests/test_weight_loading.py builds them for the JAX package.

``slow``, as the JAX package's cases are: importing ``transformers``'
CLIPModel takes ~10-20 s on the CPU. Tolerance: the JAX package's 1e-3
(absolute and relative); each case prints the gap it measured.
"""

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from tvc_torch.models import loaders as pl  # noqa: E402

pytestmark = pytest.mark.slow


def _hf_clip():
    cfg = transformers.CLIPConfig(
        text_config=dict(vocab_size=512, hidden_size=64, intermediate_size=256, num_hidden_layers=2,
                         num_attention_heads=2, max_position_embeddings=16, hidden_act="quick_gelu",
                         # HF pools at the eos position; the port at the argmax id (EOT)
                         bos_token_id=510, eos_token_id=511, pad_token_id=0),
        vision_config=dict(hidden_size=64, intermediate_size=256, num_hidden_layers=2, num_attention_heads=2,
                           image_size=32, patch_size=16, hidden_act="quick_gelu"),
        projection_dim=32,
    )
    torch.manual_seed(0)
    return transformers.CLIPModel(cfg).eval()


def test_clip_matches_transformers(tmp_path):
    """CLIPConfig.tiny() through load_clip_weights from the HF model's own
    safetensors: image and text embeddings within 1e-3."""
    from tvc_torch.models.clip import CLIPConfig

    hf = _hf_clip()
    hf.save_pretrained(str(tmp_path), safe_serialization=True)
    assert set(pl.clip_state_dict_shapes(CLIPConfig.tiny(), position_ids=False)) <= set(hf.state_dict())
    model = pl.load_clip_weights(CLIPConfig.tiny(), str(tmp_path), device="cpu")
    rng = np.random.default_rng(0)
    pixels = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)  # pre-normalized
    tokens = np.zeros((2, 16), np.int64)
    tokens[:, 0] = 510
    tokens[0, 1:4] = [5, 17, 511]
    tokens[1, 1:6] = [9, 33, 100, 2, 511]
    with torch.no_grad():
        want_img = hf.get_image_features(pixel_values=torch.tensor(pixels).permute(0, 3, 1, 2)).numpy()
        want_txt = hf.get_text_features(input_ids=torch.tensor(tokens),
                                        attention_mask=torch.ones_like(torch.tensor(tokens))).numpy()
        got_img = model.image_features(model.params, torch.tensor(pixels)).numpy()
        got_txt = model.text_features(model.params, torch.tensor(tokens)).numpy()
    print(f"CLIP vs transformers: image max |d| {np.abs(got_img - want_img).max():.3e}, "
          f"text {np.abs(got_txt - want_txt).max():.3e}")
    np.testing.assert_allclose(got_img, want_img, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(got_txt, want_txt, atol=1e-3, rtol=1e-3)


def test_qwen_matches_transformers(tmp_path):
    """QwenConfig.tiny() through load_qwen_weights from the HF model's
    safetensors: causal logits within 1e-3."""
    from tvc_torch.models.qwen import QwenConfig

    cfg = QwenConfig.tiny()
    hf_cfg = transformers.Qwen2Config(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size, intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_kv_heads,
        max_position_embeddings=cfg.max_seq_len, rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_eps,
        tie_word_embeddings=cfg.tie_embeddings, attention_dropout=0.0,
    )
    torch.manual_seed(1)
    hf = transformers.Qwen2ForCausalLM(hf_cfg).eval()
    hf.save_pretrained(str(tmp_path), safe_serialization=True)
    assert set(pl.qwen_state_dict_shapes(cfg)) == set(k for k in hf.state_dict() if k != "lm_head.weight")
    model = pl.load_qwen_weights(cfg, str(tmp_path), device="cpu", max_new_tokens=4)
    tokens = np.random.default_rng(2).integers(1, cfg.vocab_size - 4, size=(2, 7))
    T = tokens.shape[1]
    positions = torch.arange(T).expand(2, T)
    mask = torch.zeros(T, T).masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(), float("-inf"))[None, None]
    with torch.no_grad():
        want = hf(input_ids=torch.tensor(tokens)).logits.numpy()
        got, _ = model.module.apply(model.params, torch.tensor(tokens), positions, mask.expand(2, 1, T, T))
    got = got.numpy()
    print(f"Qwen vs transformers: logits max |d| {np.abs(got - want).max():.3e}")
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
