"""The defended serving step and the CLIP training step on one device
(port of ``make_serving_step``, its compat wrapper ``make_defense_step``
and ``make_train_step``, ``tvc/parallel/steps.py``).

One call computes the CLIP image encode, one text-tower pass for the
originals and the variants, the exact bank top-k by the text embedding,
the reference gather and the consistency scoring, then the two-sided band
decision. With ``config.fused_attention`` the towers run the hand-written
layer kernels (the W8A8 ones with ``config.int8_serving``); scoring runs the
consistency kernel for CUDA tensors (each wrapper picks its plain version
only for CPU tensors). The training step differentiates the einsum
module (the kernels define no backward pass).
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
from tvc_torch.core.similarity import l2_normalize
from tvc_torch.models.clip import CLIPModel, _flatten, _unflatten, bucket_text_tokens, normalize_pixels
from tvc_torch.optim import AdamW, adamw, apply_updates

_SCORE_KEYS = (
    "tv_score", "sd_score", "consistency_score", "aggregated",
    "is_adversarial", "orig_similarity", "variant_mean", "variant_std",
)


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

    * ``pixels`` [B,H,W,3] raw [0, 1]; ``tokens`` [B,T]; ``variant_tokens``
      [B,V,T] + ``variant_mask`` [B,V] bool;
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

    Single device only: ``mesh`` raises.
    """
    if mesh is not None:
        raise NotImplementedError("mesh serving is not ported yet: single device only")
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"model is on {model.device}, step on {device}")
    num_refs = min(num_refs or top_k, top_k)

    def _dev(x, dtype=None) -> Tensor:
        return torch.as_tensor(x, dtype=dtype, device=device)

    def _finish(params, img, allf, variant_mask, bank, valid, weights, lower, upper):
        B = img.shape[0]
        txt = allf[:, 0].contiguous()
        var = allf[:, 1:].contiguous()
        bank = _dev(bank, torch.float32)
        if with_bank:
            # references are fetched by the TEXT embedding: the text
            # retrieves what the image should look like
            sims = (txt @ bank.T).masked_fill(~_dev(valid, torch.bool)[None, :], float("-inf"))
            ref_idx = topk_index_order(sims, top_k)[1]  # ties: lower index first
            refs = bank[ref_idx[:, :num_refs].reshape(-1)].reshape(B, num_refs, -1)
            ref_mask = torch.ones((B, num_refs), dtype=torch.bool, device=device)
            ref_idx = ref_idx.to(torch.int32)
        else:
            refs = torch.zeros((B, 1, img.shape[-1]), dtype=torch.float32, device=device)
            ref_mask = torch.zeros((B, 1), dtype=torch.bool, device=device)
            ref_idx = torch.full((B, top_k), -1, dtype=torch.int32, device=device)
        score = consistency_scores_reference if use_kernel is False else fused_consistency_scores
        scores = score(
            img, txt, var, refs,
            variant_mask=_dev(variant_mask, torch.bool).contiguous(),
            ref_mask=ref_mask,
            weights=_dev(weights, torch.float32),
            threshold=_dev(upper, torch.float32),
        )
        out: Dict[str, Tensor] = {k: scores[k] for k in _SCORE_KEYS}
        out["is_adversarial"] = out["is_adversarial"] | (
            out["aggregated"] < _dev(lower, torch.float32)
        )
        out["ref_idx"] = ref_idx
        out["img"] = img
        return out

    def _encode_image(params, pixels):
        px = normalize_pixels(_dev(pixels, torch.float32))
        return l2_normalize(model.infer_image_features(params, px, qparams=qparams))

    @torch.no_grad()
    def step(params, pixels, tokens, variant_tokens, variant_mask, bank, valid, weights, lower, upper):
        img = _encode_image(params, pixels)
        tokens = _dev(tokens, torch.long)
        variant_tokens = _dev(variant_tokens, torch.long)
        B, V, T = variant_tokens.shape
        # ONE text-tower pass for originals + variants ([B*(V+1), T])
        all_tok = torch.cat([tokens[:, None, :], variant_tokens], dim=1).reshape(B * (V + 1), T)
        allf = l2_normalize(model.infer_text_features(params, all_tok, qparams=qparams))
        allf = allf.reshape(B, V + 1, -1)
        return _finish(params, img, allf, variant_mask, bank, valid, weights, lower, upper)

    @torch.no_grad()
    def step_bucketed(params, pixels, short_tok, long_tok, inv_perm, variant_mask,
                      bank, valid, weights, lower, upper):
        """``step`` with the [B*(V+1)] text rows in two length buckets
        (exact: the tower is length-polymorphic)."""
        img = _encode_image(params, pixels)
        B, V = variant_mask.shape
        allf = model.infer_text_features_bucketed(
            params, _dev(short_tok, torch.long), _dev(long_tok, torch.long),
            _dev(inv_perm, torch.long), qparams=qparams,
        )
        allf = l2_normalize(allf).reshape(B, V + 1, -1)
        return _finish(params, img, allf, variant_mask, bank, valid, weights, lower, upper)

    def serve(params, pixels, tokens, variant_tokens, variant_mask, bank, valid, weights, lower, upper):
        if isinstance(tokens, np.ndarray) and isinstance(variant_tokens, np.ndarray):
            B, V, T = variant_tokens.shape
            all_tok = np.concatenate([tokens[:, None, :], variant_tokens], axis=1).reshape(B * (V + 1), T)
            bucket = bucket_text_tokens(all_tok, short_len=bucket_short_len, dedup=True)
            if bucket is not None:
                serve.bucketed_calls += 1
                return step_bucketed(
                    params, pixels, bucket["short"], bucket["long"], bucket["inv"],
                    variant_mask, bank, valid, weights, lower, upper,
                )
        return step(params, pixels, tokens, variant_tokens, variant_mask, bank, valid, weights, lower, upper)

    serve.bucketed_calls = 0
    return serve


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
    bank row as valid. Only ``mesh=None``: the mesh paths belong to the
    multi-GPU slice and raise ``NotImplementedError``.
    """
    if mesh is not None:
        raise NotImplementedError(
            "make_defense_step over a mesh is not ported yet (the multi-GPU slice): pass mesh=None"
        )
    serving = make_serving_step(model, top_k=top_k, with_bank=True, use_kernel=False, device=device)
    weights = np.asarray(
        [C.DEFAULT_WEIGHTS[m] for m in ("text_variants", "sd_reference", "consistency")], np.float32
    )

    def step(params, pixels, tokens, variant_tokens, bank, variant_mask=None):
        B, V, _ = variant_tokens.shape
        vmask = variant_mask if variant_mask is not None else np.ones((B, V), bool)
        valid = np.ones((bank.shape[0],), bool)
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
    """CLIP contrastive training step on one device.

    Returns ``(step, opt_state)``: ``step(params, opt_state, pixels, tokens)
    -> (params, opt_state, loss)``. The loss is symmetric InfoNCE over the
    batch, ``0.5 * (CE(logits, arange) + CE(logits.T, arange))``, on
    ``normalize_pixels(pixels)`` ([B, H, W, 3] raw [0, 1]) through the
    differentiable einsum module (``model.module``), in the config's
    compute dtype with f32 parameters and optimizer state.
    ``extra_loss(img_feats, txt_feats) -> scalar`` (L2-normed features) is
    added when given, e.g. ``tvc_torch.fixtures.geometry_regularizer``.

    The step is functional: it returns new tensors and mutates neither the
    parameter tree nor the state it is given. ``CLIPModel`` caches its
    compute-dtype copies per tree object, so install a result with
    ``model.params = params``.

    ``optimizer``: a ``tvc_torch.optim.AdamW``, or a learning rate or a
    schedule ``count -> lr`` for ``adamw`` (optax's defaults, weight decay
    1e-4); None is ``adamw(1e-5)``. ``opt_state`` is a tree of tensors and
    an int count. A mesh (the data-parallel step, item D11) raises
    ``NotImplementedError``. Runs on the card unless ``device="cpu"``; the
    model must be on that device.
    """
    if mesh is not None:
        raise NotImplementedError("make_train_step over a mesh (the data-parallel step, item D11) is not ported yet")
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"model is on {model.device}, step on {device}")
    if optimizer is None:
        optimizer = adamw(1e-5)
    elif not isinstance(optimizer, AdamW):
        optimizer = adamw(optimizer)
    opt_state = optimizer.init(model.params)
    module = model.module

    def loss_fn(flat: Dict[str, Tensor], pixels: Tensor, tokens: Tensor) -> Tensor:
        img, txt, logits = torch.func.functional_call(module, flat, (normalize_pixels(pixels), tokens))
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
        flat = {n: t.detach().requires_grad_(True) for n, t in _flatten(params).items()}
        with torch.enable_grad():
            loss = loss_fn(flat, px, tok)
            grads = torch.autograd.grad(loss, list(flat.values()))
        grads = _unflatten(dict(zip(flat, grads)))
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss.detach()

    return step, opt_state
