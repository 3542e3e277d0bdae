"""Checkpoint files and converters of the port (tvc_torch/_safetensors.py,
tvc_torch/_flax_msgpack.py's writer, tvc_torch/models/loaders.py) against
the libraries and the JAX package.

* safetensors written by the ``safetensors`` package are read bit-equal
  (F32 / F16 / I64 / BOOL against ``safetensors.numpy``, BF16 against
  ``safetensors.torch`` then ``.float()``); truncated files are refused;
* the msgpack writer's bytes equal ``flax.serialization.to_bytes`` for the
  same tree, and each side reads the other's;
* the CLIP and Qwen converters give the JAX converters' trees bit for bit
  on tiny HF-layout state dicts built here with numpy under the published
  key names (no ``transformers``); a missing key raises as in JAX;
* the loaders build the port's models from a directory of either format.
"""

import numpy as np
import pytest
import torch

from flax import serialization

from tvc.models import loaders as jl
from tvc_torch import _flax_msgpack as fm
from tvc_torch._safetensors import SafetensorsError, load_file
from tvc_torch.models import loaders as pl
from tvc_torch.models.clip import CLIPConfig
from tvc_torch.models.qwen import QwenConfig


def _seeded(shapes, seed=0):
    """A state dict of the given names and shapes: int64 position ids,
    the rest N(0, 0.05) f32 (norm weights around 1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in shapes.items():
        if k.endswith("position_ids"):
            out[k] = np.arange(int(np.prod(shape)), dtype=np.int64).reshape(shape)
        else:
            out[k] = rng.normal(1.0 if "norm" in k and len(shape) == 1 else 0.0, 0.05, shape).astype(np.float32)
    return out


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.dtype == w.dtype and g.shape == w.shape, (path, k, g.dtype, w.dtype, g.shape, w.shape)
            np.testing.assert_array_equal(g, w, err_msg=f"{path}/{k}")


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------


def test_safetensors_numpy_dtypes_read_bit_equal(tmp_path):
    """F32, F16, I64, BOOL and an empty tensor, written by
    safetensors.numpy (with metadata): every value equal, floats as f32;
    a dtype outside those five is refused."""
    from safetensors.numpy import load_file as st_load, save_file

    rng = np.random.default_rng(0)
    arrays = {"w32": rng.standard_normal((3, 5)).astype(np.float32),
              "w16": rng.standard_normal((7,)).astype(np.float16),
              "ids": np.arange(6, dtype=np.int64).reshape(1, 6),
              "mask": rng.random(9) > 0.5,
              "empty": np.zeros((0, 4), np.float32)}
    save_file(arrays, str(tmp_path / "a.safetensors"), metadata={"format": "pt"})
    want = st_load(str(tmp_path / "a.safetensors"))
    got = load_file(tmp_path / "a.safetensors")
    assert set(got) == set(want)
    for k, w in want.items():
        expect = w.astype(np.float32) if w.dtype.kind == "f" else w
        assert got[k].dtype == expect.dtype and got[k].shape == expect.shape
        np.testing.assert_array_equal(got[k], expect)
    save_file({"w": np.ones(3, np.float64)}, str(tmp_path / "f64.safetensors"))
    with pytest.raises(SafetensorsError, match="F64"):
        load_file(tmp_path / "f64.safetensors")


def test_safetensors_bf16_reads_as_f32(tmp_path):
    """BF16 (Qwen2's published dtype; safetensors.numpy refuses it) against
    safetensors.torch then .float(): bit-equal."""
    from safetensors.torch import save_file

    t = {"w": torch.randn(33, 17, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16),
         "b": torch.tensor([1.5, -2.0, 3e-39, float("inf")], dtype=torch.bfloat16)}
    save_file(t, str(tmp_path / "b.safetensors"))
    got = load_file(tmp_path / "b.safetensors")
    for k, v in t.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], v.float().numpy())


def test_safetensors_truncated_and_bad_files_are_refused(tmp_path):
    from safetensors.numpy import save_file

    save_file({"w": np.ones((64, 64), np.float32)}, str(tmp_path / "c.safetensors"))
    data = (tmp_path / "c.safetensors").read_bytes()
    for name, blob in (("short", data[:-1]), ("header", data[:20]), ("len", data[:5]),
                       ("huge", (2**40).to_bytes(8, "little") + data[8:])):
        (tmp_path / f"{name}.safetensors").write_bytes(blob)
        with pytest.raises(SafetensorsError):
            load_file(tmp_path / f"{name}.safetensors")


# ---------------------------------------------------------------------------
# flax msgpack
# ---------------------------------------------------------------------------


def _mixed_tree():
    rng = np.random.default_rng(1)
    return {"layer": {"kernel": rng.standard_normal((4, 3)).astype(np.float32), "bias": np.zeros(3, np.float32)},
            "scale": np.asarray(0.5, np.float32), "ids": np.arange(300, dtype=np.int64), "mask": np.ones(5, bool),
            "count": 3, "big": 2**40, "neg": -1000, "lr": 1e-3, "name": "n" * 40, "none": None,
            "seq": [np.arange(2, dtype=np.int32), 7], **{f"k{i}": i for i in range(16)}}


def test_msgpack_writer_bytes_equal_flax():
    tree = _mixed_tree()
    assert fm.to_bytes(tree) == serialization.to_bytes(tree)


def test_msgpack_torch_tensors_write_as_their_arrays():
    """A torch tree writes the bytes flax writes for the same numpy tree
    (bf16 as ml_dtypes' bfloat16); the reader widens bf16 to f32."""
    import ml_dtypes

    g = torch.Generator().manual_seed(0)
    tt = {"w": torch.randn(3, 4, generator=g), "h": torch.randn(5, generator=g).to(torch.bfloat16),
          "i": torch.arange(4, dtype=torch.int32), "s": torch.tensor(2.0)}
    nt = {"w": tt["w"].numpy(), "h": tt["h"].float().numpy().astype(ml_dtypes.bfloat16),
          "i": tt["i"].numpy(), "s": tt["s"].numpy()}
    data = fm.to_bytes(tt)
    assert data == serialization.to_bytes(nt)
    back = fm.read_state_dict(data)
    np.testing.assert_array_equal(back["h"], tt["h"].float().numpy())


def test_msgpack_each_side_reads_the_other(tmp_path):
    """flax reads the port's file into a template; the port reads flax's,
    and ``load_params`` restores into a torch template on its device."""
    tree = {"a": {"kernel": np.random.default_rng(2).standard_normal((6, 2)).astype(np.float32)},
            "b": np.arange(3, dtype=np.int32)}
    pl.save_params({"a": {"kernel": torch.tensor(tree["a"]["kernel"])}, "b": torch.tensor(tree["b"])},
                   str(tmp_path / "p.msgpack"))
    template = {"a": {"kernel": np.zeros((6, 2), np.float32)}, "b": np.zeros(3, np.int32)}
    _assert_trees_equal(serialization.from_bytes(template, (tmp_path / "p.msgpack").read_bytes()), tree)
    jl.save_params(tree, str(tmp_path / "j.msgpack"))
    back = pl.load_params({"a": {"kernel": torch.zeros(6, 2)}, "b": torch.zeros(3, dtype=torch.int32)},
                          str(tmp_path / "j.msgpack"))
    assert torch.is_tensor(back["a"]["kernel"]) and torch.is_tensor(back["b"])
    _assert_trees_equal({"a": {"kernel": back["a"]["kernel"].numpy()}, "b": back["b"].numpy()}, tree)
    with pytest.raises(ValueError, match="do not match"):
        pl.load_params({"a": {"kernel": torch.zeros(6, 2)}}, str(tmp_path / "j.msgpack"))


def test_msgpack_writer_refuses_unknown_leaves():
    with pytest.raises(fm.MsgpackError):
        fm.to_bytes({"x": object()})
    with pytest.raises(fm.MsgpackError):
        fm.to_bytes({"x": np.asarray([object()])})


# ---------------------------------------------------------------------------
# converters
# ---------------------------------------------------------------------------


def test_clip_converter_tree_equals_jax():
    """tiny CLIP (the HF key names of CLIPModel, position ids included):
    the port's tree is the JAX converter's, bit for bit, and matches the
    port model's parameter structure."""
    from tvc.models.clip import CLIPConfig as JC
    from tvc_torch.models.clip import params_from_jax

    sd = _seeded(pl.clip_state_dict_shapes(CLIPConfig.tiny()))
    got = pl.convert_clip_state_dict(sd, CLIPConfig.tiny())
    _assert_trees_equal(got, jl.convert_clip_state_dict(sd, JC.tiny()))
    params_from_jax(got, CLIPConfig.tiny())  # every name and shape of the port's module
    short = dict(sd)
    short.pop("text_model.encoder.layers.1.mlp.fc2.bias")
    with pytest.raises(KeyError):
        pl.convert_clip_state_dict(short, CLIPConfig.tiny())


@pytest.mark.parametrize("tie", [True, False])
def test_qwen_converter_tree_equals_jax(tie):
    import dataclasses

    from tvc.models.qwen import QwenConfig as JQ
    from tvc_torch.models.qwen import qwen_params_from_jax

    cfg = dataclasses.replace(QwenConfig.tiny(), tie_embeddings=tie)
    sd = _seeded(pl.qwen_state_dict_shapes(cfg), seed=3)
    got = pl.convert_qwen_state_dict(sd, cfg)
    _assert_trees_equal(got, jl.convert_qwen_state_dict(sd, dataclasses.replace(JQ.tiny(), tie_embeddings=tie)))
    qwen_params_from_jax(got, cfg)
    short = dict(sd)
    short.pop("model.layers.0.self_attn.k_proj.bias")
    with pytest.raises(KeyError):
        pl.convert_qwen_state_dict(short, cfg)


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------


def _write_both_formats(sd, root):
    from safetensors.numpy import save_file

    (root / "st").mkdir()
    (root / "bin").mkdir()
    save_file(sd, str(root / "st" / "model.safetensors"))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, root / "bin" / "pytorch_model.bin")


def test_load_state_dict_reads_both_formats_and_shards(tmp_path):
    from safetensors.numpy import save_file

    sd = _seeded(pl.clip_state_dict_shapes(CLIPConfig.tiny()))
    _write_both_formats(sd, tmp_path)
    a, b = pl.load_state_dict(str(tmp_path / "st")), pl.load_state_dict(str(tmp_path / "bin"))
    assert set(a) == set(b) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(a[k], sd[k])
        np.testing.assert_array_equal(b[k], sd[k].astype(np.float32))  # the .bin branch floats every leaf
    keys = sorted(sd)
    (tmp_path / "shards").mkdir()
    save_file({k: sd[k] for k in keys[::2]}, str(tmp_path / "shards" / "model-00001-of-00002.safetensors"))
    save_file({k: sd[k] for k in keys[1::2]}, str(tmp_path / "shards" / "model-00002-of-00002.safetensors"))
    assert set(pl.load_state_dict(str(tmp_path / "shards"))) == set(sd)
    (tmp_path / "none").mkdir()
    with pytest.raises(FileNotFoundError):
        pl.load_state_dict(str(tmp_path / "none"))


def test_load_clip_weights_builds_the_port_model(tmp_path, monkeypatch):
    """Both formats give one tree bit for bit; the model's parameters are
    the converted tree; no checkout returns None."""
    sd = _seeded(pl.clip_state_dict_shapes(CLIPConfig.tiny()))
    _write_both_formats(sd, tmp_path)
    a = pl.load_clip_weights(CLIPConfig.tiny(), str(tmp_path / "st"), device="cpu")
    b = pl.load_clip_weights(CLIPConfig.tiny(), str(tmp_path / "bin"), device="cpu")
    from tvc_torch.models.clip import _flatten

    fa, fb = _flatten(a.params), _flatten(b.params)
    want = _flatten(pl.convert_clip_state_dict(sd, CLIPConfig.tiny()))
    for k in want:
        assert torch.equal(fa[k], fb[k])
        np.testing.assert_array_equal(fa[k].numpy(), want[k])
    monkeypatch.delenv("TVC_CLIP_WEIGHTS", raising=False)
    assert pl.load_clip_weights(CLIPConfig.tiny(), device="cpu") is None
    assert pl.load_clip_weights(CLIPConfig.tiny(), str(tmp_path / "missing"), device="cpu") is None
    monkeypatch.setenv("TVC_CLIP_WEIGHTS", str(tmp_path / "st"))
    with pytest.warns(UserWarning, match="hash fallback"):
        assert pl.load_clip_weights(CLIPConfig.tiny(), device="cpu") is not None
    monkeypatch.setenv("TVC_STRICT_TOKENIZER", "1")
    with pytest.raises(RuntimeError, match="hash fallback"):
        pl.load_clip_weights(CLIPConfig.tiny(), device="cpu")


def test_load_qwen_weights_builds_the_port_model(tmp_path):
    """A BF16 safetensors Qwen (the published dtype) loads as the f32
    widening of its values; the greedy decode runs."""
    from safetensors.torch import save_file

    from tvc_torch.models.clip import _flatten

    cfg = QwenConfig.tiny()
    sd = _seeded(pl.qwen_state_dict_shapes(cfg), seed=4)
    bf = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in sd.items()}
    save_file(bf, str(tmp_path / "model.safetensors"))
    m = pl.load_qwen_weights(cfg, str(tmp_path), device="cpu", max_new_tokens=2)
    want = _flatten(pl.convert_qwen_state_dict({k: v.float().numpy() for k, v in bf.items()}, cfg))
    got = _flatten(m.params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    assert len(m.generate(["a b"], temperature=0.0)) == 1


def test_load_sd_weights_builds_the_sampler(tmp_path):
    """A diffusers-layout checkout (unet/, vae/; f16 safetensors) at the
    tiny HF configs: the converted trees land in the HF modules, and the
    model's UNet call runs on them."""
    from safetensors.numpy import save_file
    from test_sd_hf import synthetic_unet_sd, synthetic_vae_sd

    from tvc.models.sd_hf import HFUNetConfig as JU, HFVAEConfig as JV
    from tvc_torch.models.sd import load_params, module_tree_from_jax
    from tvc_torch.models.sd_hf import HFUNet, HFUNetConfig, HFVAEConfig

    for sub, sd in (("unet", synthetic_unet_sd(JU.tiny())), ("vae", synthetic_vae_sd(JV.tiny()))):
        (tmp_path / sub).mkdir()
        save_file({k: v.astype(np.float16) for k, v in sd.items()},
                  str(tmp_path / sub / "diffusion_pytorch_model.safetensors"))
    model = pl.load_sd_weights(str(tmp_path), image_size=16, unet_config=HFUNetConfig.tiny(),
                               vae_config=HFVAEConfig.tiny(), device="cpu")
    assert isinstance(model.unet, HFUNet)
    unet_sd = {k: v.astype(np.float16).astype(np.float32) for k, v in synthetic_unet_sd(JU.tiny()).items()}
    ref = HFUNet(HFUNetConfig.tiny(), device="cpu")
    load_params(ref, module_tree_from_jax(ref, pl.convert_sd_unet_state_dict(unet_sd, HFUNetConfig.tiny())))
    want = dict(ref.named_parameters())
    for k, p in model.unet.named_parameters():
        assert torch.equal(p, want[k]), k
    eps = model._apply("unet", torch.zeros(2, 8, 8, 4), torch.tensor([1.0, 500.0]), torch.ones(2, 6, 32))
    assert eps.shape == (2, 8, 8, 4) and bool(torch.isfinite(eps).all())
    assert pl.load_sd_weights(str(tmp_path / "missing"), device="cpu") is None
