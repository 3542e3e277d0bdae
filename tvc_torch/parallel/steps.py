"""The defended serving step and the CLIP training step, on one device or
over a mesh (port of ``make_serving_step``, its compat wrapper
``make_defense_step`` and ``make_train_step``, ``tvc/parallel/steps.py``).

One call computes one text-tower pass for the originals and the variants,
the exact bank top-k by the text embedding and the reference gather, the
CLIP image encode (last of the three, so the pixels' upload overlaps the
rest), the consistency scoring, then the two-sided band decision. With
``config.fused_attention`` the towers run the hand-written
layer kernels (the W8A8 ones with ``config.int8_serving``); scoring runs the
consistency kernel for CUDA tensors (each wrapper picks its plain version
only for CPU tensors). The training step differentiates the einsum
module (the kernels define no backward pass).

Over a mesh (``tvc_torch.parallel.mesh``) every rank calls the step with
the same global host batch and its own bank shard: the rank encodes and
scores its ``data``-axis block of the batch with the same kernels as one
device, the text features are gathered for the sharded top-k
(``tvc_torch.bank.index.sharded_topk``), and the outputs are gathered over
``data``, so every rank returns the global result. The training step runs
data-parallel: each rank encodes its block, the symmetric InfoNCE runs over
the gathered global batch, and the gradients are summed over ``data``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from tvc_torch._device import resolve_device
from tvc_torch.core import consistency as C
from tvc_torch.core.kernels.consistency_kernel import consistency_scores_reference, fused_consistency_scores
from tvc_torch.core.kernels.topk_kernel import topk_index_order
from tvc_torch.core.staging import Upload, stager
from tvc_torch.core.similarity import l2_normalize
from tvc_torch.models.clip import (
    CLIPModel,
    _flatten,
    _unflatten,
    bucket_text_tokens,
    bucket_text_tokens_sharded,
    normalize_pixels,
)
from tvc_torch.optim import AdamW, adamw, apply_updates
from tvc_torch.parallel.mesh import (
    DATA_AXIS,
    all_gather,
    all_gather_with_grad,
    all_reduce,
    axis_index,
    axis_size,
    bank_shard_axis,
    mesh_device,
    pad_to_multiple,
    shard_rows,
)

_SCORE_KEYS = (
    "tv_score", "sd_score", "consistency_score", "aggregated",
    "is_adversarial", "orig_similarity", "variant_mean", "variant_std",
)


def _step_device(model: CLIPModel, mesh, device) -> torch.device:
    """The mesh's device (a ``device`` naming another raises), else the
    resolved one; the model must live there."""
    if mesh is not None:
        dev = mesh_device(mesh)
        if device is not None and resolve_device(device) != dev:
            raise ValueError(f"device {device} is not the mesh's {dev}")
    else:
        dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"model is on {model.device}, step on {dev}")
    return dev


def make_serving_step(
    model: CLIPModel,
    mesh=None,
    top_k: int = 5,
    with_bank: bool = True,
    use_kernel: Optional[bool] = None,
    num_refs: Optional[int] = None,
    qparams=None,
    bucket_short_len: int = 16,
    device: Optional[Union[str, torch.device]] = None,
) -> Callable:
    """The serving hot path.

    Returns ``serve(params, pixels, tokens, variant_tokens, variant_mask,
    bank, valid, weights, lower, upper) -> dict``:

    * ``pixels`` [B,H,W,3] raw [0, 1]: a host array or tensor (a host array
      goes to the device through the device's pinned stager,
      ``tvc_torch.core.staging``, while the text tower and the bank top-k
      are launched), or an ``Upload`` that the caller started earlier;
      ``tokens`` [B,T]; ``variant_tokens`` [B,V,T] + ``variant_mask`` [B,V]
      bool;
    * ``bank`` [N,D] + ``valid`` [N] bool masking pad rows (pass
      zeros((1, D)) / zeros(1) with ``with_bank=False``);
    * ``weights`` [3] and the ``lower`` / ``upper`` thresholds are run-time
      values: changing them changes no code path;
    * decision: ``agg > upper | agg < lower``.

    Host (numpy) token batches are split into two length buckets with
    duplicate rows removed (:func:`bucket_text_tokens`) when that pays;
    tensor tokens encode as one batch. Output keys: ``is_adversarial``,
    ``aggregated``, ``tv_score``, ``sd_score``, ``consistency_score``,
    ``orig_similarity``, ``variant_mean``, ``variant_std``, ``ref_idx``
    ([B, top_k] int32; -1 without a bank), ``img`` (L2-normed image
    features). Scores the first ``num_refs <= top_k`` retrieved rows.

    ``use_kernel=False`` scores with the plain consistency version
    (``consistency_scores_reference``) on every device; None / True with
    ``fused_consistency_scores``.

    ``qparams``: the int8 serving weights (``CLIPModel.qparams()``) for
    ``config.int8_serving``, used by every tower call of the step; None
    quantizes them from ``params`` in each call.

    ``mesh``: every rank passes the same global batch (B divisible by the
    ``data`` axis) and ``bank`` / ``valid`` of its own row shard on the bank
    axis (``EmbeddingBank(mesh=...)``'s layout); every rank returns the
    global outputs. Host token batches bucket per shard
    (:func:`bucket_text_tokens_sharded`) whenever a mesh is given, one
    ``data`` shard included, as the JAX package's step does.
    """
    from tvc_torch.bank.index import gather_rows, sharded_topk  # the bank module imports this package

    device = _step_device(model, mesh, device)
    num_refs = min(num_refs or top_k, top_k)
    dp = axis_size(mesh, DATA_AXIS) if mesh is not None else 1

    def _dev(x, dtype=None) -> Tensor:
        return torch.as_tensor(x, dtype=dtype, device=device)

    def _local(x, dtype=None) -> Tensor:
        """This rank's ``data`` block of a global batch input."""
        t = _dev(x, dtype)
        return shard_rows(t, mesh, DATA_AXIS) if mesh is not None else t

    def _topk_refs(txt: Tensor, bank: Tensor, valid: Tensor) -> Tuple[Tensor, Tensor]:
        """(ref_idx [B, top_k] int64 global, refs [b, num_refs, D] of this
        rank's rows) for the text features ``txt`` [b, D] of this rank."""
        if mesh is None:
            sims = (txt @ bank.T).masked_fill(~valid[None, :], float("-inf"))
            ref_idx = topk_index_order(sims, top_k)[1]  # ties: lower index first
            refs = bank[ref_idx[:, :num_refs].reshape(-1)].reshape(txt.shape[0], num_refs, -1)
            return ref_idx, refs
        axis = bank_shard_axis(mesh)
        txt_all = all_gather(txt, mesh, DATA_AXIS)  # [B, D]: every query meets every bank shard
        ref_idx = sharded_topk(txt_all, bank, valid, top_k, mesh, axis)[1]
        refs = gather_rows(bank, ref_idx[:, :num_refs], mesh, axis)  # [B, R, D]
        b = txt.shape[0]
        k = axis_index(mesh, DATA_AXIS)
        return ref_idx, refs[k * b : (k + 1) * b]

    def _finish(params, pixels, allf, variant_mask, bank, valid, weights, lower, upper):
        """The bank top-k (text features only), then the image encode once
        the pixels are on the device, then the scoring."""
        b = allf.shape[0]
        txt = allf[:, 0].contiguous()
        var = allf[:, 1:].contiguous()
        if with_bank:
            # references are fetched by the TEXT embedding: the text
            # retrieves what the image should look like
            ref_idx, refs = _topk_refs(txt, _dev(bank, torch.float32), _dev(valid, torch.bool))
            ref_mask = torch.ones((b, num_refs), dtype=torch.bool, device=device)
            ref_idx = ref_idx.to(torch.int32)
        else:
            refs = torch.zeros((b, 1, allf.shape[-1]), dtype=torch.float32, device=device)
            ref_mask = torch.zeros((b, 1), dtype=torch.bool, device=device)
            ref_idx = torch.full((b * dp, top_k), -1, dtype=torch.int32, device=device)
        img = _encode_image(params, pixels)
        score = consistency_scores_reference if use_kernel is False else fused_consistency_scores
        scores = score(
            img, txt, var, refs,
            variant_mask=_local(variant_mask, torch.bool).contiguous(),
            ref_mask=ref_mask,
            weights=_dev(weights, torch.float32),
            threshold=_dev(upper, torch.float32),
        )
        out: Dict[str, Tensor] = {k: scores[k] for k in _SCORE_KEYS}
        out["is_adversarial"] = out["is_adversarial"] | (
            out["aggregated"] < _dev(lower, torch.float32)
        )
        out["img"] = img
        if mesh is not None:
            out = _gather_outputs(out, mesh)
        out["ref_idx"] = ref_idx
        return out

    def _encode_image(params, pixels: Upload):
        px = pixels.wait().to(device)
        if mesh is not None:
            px = shard_rows(px, mesh, DATA_AXIS)
        return l2_normalize(model.infer_image_features(params, normalize_pixels(px), qparams=qparams))

    @torch.no_grad()
    def step(params, pixels, tokens, variant_tokens, variant_mask, bank, valid, weights, lower, upper):
        tokens = _local(tokens, torch.long)
        variant_tokens = _local(variant_tokens, torch.long)
        b, V, T = variant_tokens.shape
        # ONE text-tower pass for originals + variants ([b*(V+1), T])
        all_tok = torch.cat([tokens[:, None, :], variant_tokens], dim=1).reshape(b * (V + 1), T)
        allf = l2_normalize(model.infer_text_features(params, all_tok, qparams=qparams))
        allf = allf.reshape(b, V + 1, -1)
        return _finish(params, pixels, allf, variant_mask, bank, valid, weights, lower, upper)

    @torch.no_grad()
    def step_bucketed(params, pixels, short_tok, long_tok, inv_perm, variant_mask,
                      bank, valid, weights, lower, upper):
        """``step`` with the [B*(V+1)] text rows in two length buckets
        (exact: the tower is length-polymorphic); over a mesh each bucket
        array stacks the shards' blocks and ``inv_perm`` holds local
        indices."""
        b = pixels.shape[0] // dp
        V = variant_mask.shape[1]
        allf = model.infer_text_features_bucketed(
            params, _local(short_tok, torch.long), _local(long_tok, torch.long),
            _local(inv_perm, torch.long), qparams=qparams,
        )
        allf = l2_normalize(allf).reshape(b, V + 1, -1)
        return _finish(params, pixels, allf, variant_mask, bank, valid, weights, lower, upper)

    def serve(params, pixels, tokens, variant_tokens, variant_mask, bank, valid, weights, lower, upper):
        if pixels.shape[0] % dp:
            raise ValueError(f"batch {pixels.shape[0]} is not divisible by the {dp} ranks of the data axis")
        if not isinstance(pixels, Upload):
            pixels = stager(device).start(pixels)
        if isinstance(tokens, np.ndarray) and isinstance(variant_tokens, np.ndarray):
            B, V, T = variant_tokens.shape
            all_tok = np.concatenate([tokens[:, None, :], variant_tokens], axis=1).reshape(B * (V + 1), T)
            if mesh is None:
                bucket = bucket_text_tokens(all_tok, short_len=bucket_short_len, dedup=True)
            else:
                bucket = bucket_text_tokens_sharded(all_tok, dp, short_len=bucket_short_len, dedup=True)
            if bucket is not None:
                serve.bucketed_calls += 1
                return step_bucketed(
                    params, pixels, bucket["short"], bucket["long"], bucket["inv"],
                    variant_mask, bank, valid, weights, lower, upper,
                )
        return step(params, pixels, tokens, variant_tokens, variant_mask, bank, valid, weights, lower, upper)

    serve.bucketed_calls = 0
    return serve


def _gather_outputs(out: Dict[str, Tensor], mesh) -> Dict[str, Tensor]:
    """Every rank's per-query outputs (the score keys and ``img``) gathered
    over ``data`` in one collective: packed as f32 columns [b, 8 + D]."""
    cols = [out[k].float()[:, None] for k in _SCORE_KEYS] + [out["img"].float()]
    full = all_gather(torch.cat(cols, dim=1), mesh, DATA_AXIS)
    res = {k: full[:, i].to(out[k].dtype) for i, k in enumerate(_SCORE_KEYS)}
    res["img"] = full[:, len(_SCORE_KEYS):].to(out["img"].dtype)
    return res


def make_defense_step(
    model: CLIPModel,
    mesh,
    bank_rows_per_shard: int,  # kept for the JAX signature; rows come from shapes
    top_k: int = 5,
    threshold: float = C.DEFAULT_THRESHOLD,
    device: Optional[Union[str, torch.device]] = None,
) -> Callable:
    """Compat wrapper over :func:`make_serving_step` with the plain
    consistency scoring (``use_kernel=False``), as the JAX package's.

    Returns ``step(params, pixels, tokens, variant_tokens, bank,
    variant_mask=None) -> (is_adversarial [B], aggregated [B], topk_idx [B,
    k])``; ``variant_mask=None`` takes every variant slot as real and every
    bank row as valid. ``bank`` is the global [N, D] bank on every rank: over
    a mesh each rank keeps its row shard (padded with invalid rows to a
    multiple of the bank axis).
    """
    serving = make_serving_step(model, mesh, top_k=top_k, with_bank=True, use_kernel=False, device=device)
    weights = np.asarray(
        [C.DEFAULT_WEIGHTS[m] for m in ("text_variants", "sd_reference", "consistency")], np.float32
    )

    def step(params, pixels, tokens, variant_tokens, bank, variant_mask=None):
        B, V, _ = variant_tokens.shape
        vmask = variant_mask if variant_mask is not None else np.ones((B, V), bool)
        valid = np.ones((bank.shape[0],), bool)
        if mesh is not None:
            axis = bank_shard_axis(mesh)
            rows = pad_to_multiple(bank.shape[0], axis_size(mesh, axis))
            bank_t = torch.zeros((rows, bank.shape[1]), dtype=torch.float32)
            bank_t[: bank.shape[0]] = torch.as_tensor(np.asarray(bank, np.float32) if not torch.is_tensor(bank)
                                                      else bank.detach().cpu().float())
            bank, valid = shard_rows(bank_t, mesh, axis), shard_rows(np.arange(rows) < len(valid), mesh, axis)
        out = serving(params, pixels, tokens, variant_tokens, vmask, bank, valid, weights,
                      np.float32(-np.inf), np.float32(threshold))
        return out["is_adversarial"], out["aggregated"], out["ref_idx"]

    return step


def make_train_step(
    model: CLIPModel,
    mesh=None,
    optimizer: Optional[Union[AdamW, float, Callable[[int], float]]] = None,
    extra_loss: Optional[Callable] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[Callable, Any]:
    """CLIP contrastive training step, on one device or data-parallel over
    a mesh.

    Returns ``(step, opt_state)``: ``step(params, opt_state, pixels, tokens)
    -> (params, opt_state, loss)``. The loss is symmetric InfoNCE over the
    global batch, ``0.5 * (CE(logits, arange) + CE(logits.T, arange))``, on
    ``normalize_pixels(pixels)`` ([B, H, W, 3] raw [0, 1]) through the
    differentiable einsum module (``model.module``), in the config's
    compute dtype with f32 parameters and optimizer state.
    ``extra_loss(img_feats, txt_feats) -> scalar`` (L2-normed features of
    the global batch) is added when given, e.g.
    ``tvc_torch.fixtures.geometry_regularizer``.

    Over a mesh every rank passes the same global batch (B divisible by the
    ``data`` axis) and the same replicated parameters and state: the rank
    encodes its block, the features are gathered over ``data`` (autograd
    through the gather) for the [B, B] logits, each rank differentiates
    loss / dp, and the gradients are summed over ``data``, so one step
    equals the single-device step on the global batch up to the order of
    the f32 sums. Parameters and AdamW state stay replicated.

    The step is functional: it returns new tensors and mutates neither the
    parameter tree nor the state it is given. ``CLIPModel`` caches its
    compute-dtype copies per tree object, so install a result with
    ``model.params = params``.

    ``optimizer``: a ``tvc_torch.optim.AdamW``, or a learning rate or a
    schedule ``count -> lr`` for ``adamw`` (optax's defaults, weight decay
    1e-4); None is ``adamw(1e-5)``. ``opt_state`` is a tree of tensors and
    an int count. Runs on the card unless ``device="cpu"`` (or a CPU mesh);
    the model must be on that device.
    """
    device = _step_device(model, mesh, device)
    if optimizer is None:
        optimizer = adamw(1e-5)
    elif not isinstance(optimizer, AdamW):
        optimizer = adamw(optimizer)
    opt_state = optimizer.init(model.params)
    module = model.module
    dp = axis_size(mesh, DATA_AXIS) if mesh is not None else 1

    def loss_fn(flat: Dict[str, Tensor], pixels: Tensor, tokens: Tensor) -> Tensor:
        # CLIPModule.forward's computation, with this rank's block through
        # the towers and the global [B, B] logits from the gathered features
        img = l2_normalize(torch.func.functional_call(module.visual, _sub(flat, "visual"),
                                                      (normalize_pixels(pixels),)))
        txt = l2_normalize(torch.func.functional_call(module.text, _sub(flat, "text"), (tokens,)))
        if mesh is not None:
            img = all_gather_with_grad(img, mesh, DATA_AXIS)
            txt = all_gather_with_grad(txt, mesh, DATA_AXIS)
        logits = torch.exp(flat["logit_scale"]) * img @ txt.T
        labels = torch.arange(logits.shape[0], device=logits.device)
        loss = 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))
        if extra_loss is not None:
            loss = loss + extra_loss(img, txt)
        return loss

    def step(params: Dict, opt_state: Dict, pixels, tokens):
        px = torch.as_tensor(np.asarray(pixels, np.float32) if not torch.is_tensor(pixels) else pixels,
                             dtype=torch.float32, device=device)
        tok = torch.as_tensor(np.asarray(tokens) if not torch.is_tensor(tokens) else tokens,
                              dtype=torch.long, device=device)
        if mesh is not None:
            px, tok = shard_rows(px, mesh, DATA_AXIS), shard_rows(tok, mesh, DATA_AXIS)
        flat = {n: t.detach().requires_grad_(True) for n, t in _flatten(params).items()}
        with torch.enable_grad():
            loss = loss_fn(flat, px, tok)
            # each rank's share: the gather's backward sums the ranks'
            # gradients, so loss / dp on each sums to the global loss
            grads = torch.autograd.grad(loss / dp, list(flat.values()))
        if mesh is not None:
            grads = _sum_over_data(grads, mesh)
        grads = _unflatten(dict(zip(flat, grads)))
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss.detach()

    return step, opt_state


def _sub(flat: Dict[str, Tensor], prefix: str) -> Dict[str, Tensor]:
    """The entries of one submodule, with its prefix taken off."""
    return {n[len(prefix) + 1:]: t for n, t in flat.items() if n.startswith(prefix + ".")}


def _sum_over_data(grads, mesh):
    """Every rank's gradients summed over ``data`` in one collective (the
    tensors packed into one f32 buffer)."""
    sizes = [g.numel() for g in grads]
    total = all_reduce(torch.cat([g.reshape(-1).float() for g in grads]), mesh, DATA_AXIS)
    return [t.reshape(g.shape).to(g.dtype) for t, g in zip(total.split(sizes), grads)]
