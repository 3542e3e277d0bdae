"""The plain reference against the program's own plain (CPU) versions at
tiny widths, on the same seeded inputs: the int8 CLIP towers, the TVC
scoring, the Qwen2 w8 decoder and both tokenizers. The reference is
written apart from the program; these tests show the two describe the
same function."""

import numpy as np
import torch

from perfbench import traffic, weights
from perfbench.reference import clip_int8 as ref
from perfbench.reference import qwen2 as qref
from perfbench.reference.tokenizers import ClipBPE, QwenBPE
from perfbench.tests.conftest import TINY_CLIP, TINY_QWEN

CAPTIONS = traffic.distinct_captions()[:400]


def test_clip_bpe_equals_the_programs():
    from tvc_torch.models.tokenizer import get_tokenizer

    ours, theirs = ClipBPE(77), get_tokenizer(49408, 77)
    assert np.array_equal(ours(CAPTIONS), theirs(CAPTIONS))


def test_qwen_bpe_equals_the_programs():
    from tvc_torch.models.tokenizer import get_tokenizer

    theirs, ours = get_tokenizer(151936, 512), QwenBPE()
    texts = [qref.PARAPHRASE_PROMPT.format(text=t) for t in CAPTIONS[:100]]
    for t, row in zip(texts, theirs(texts)):
        ids = ours.encode(t)
        assert list(row[: len(ids)]) == ids and (len(ids) == len(row) or row[len(ids)] == theirs.pad_id)
    assert ours.eos == theirs.eot_id


def _clip_cfg():
    from perfbench import common

    c = dict(common.config("clip-vit-b32-int8"))
    c.update(TINY_CLIP)
    return c


def test_int8_towers_equal_the_programs_plain_int8_towers():
    """f32 compute on both sides: the program's CPU route runs its plain
    W8A8 layer versions. The two sum the attention products in another
    order, so an activation can land on the other side of a rounding
    boundary of its int8 quantum; 2e-4 on unit features is well above that
    and far below a wrong scale, bias or pooling (O(1e-1))."""
    from tvc_torch.models.clip import CLIPConfig, CLIPModel, normalize_pixels

    c = _clip_cfg()
    p = weights.clip_params(c, 11, "cpu")
    keys = ("image_size", "patch_size", "vision_width", "vision_layers", "vision_heads", "vocab_size",
            "context_length", "text_width", "text_layers", "text_heads", "embed_dim")
    prog = CLIPModel(CLIPConfig(**{k: c[k] for k in keys}, dtype=torch.float32, fused_attention=True,
                                int8_serving=True), params=weights.nest(p), device="cpu")
    px = weights.images(6, c["image_size"], 11, "cpu")
    mine = ref.ClipInt8(c, p)
    theirs = ref.l2n(prog.infer_image_features(prog.params, normalize_pixels(px)))
    assert (mine.image_features(px) - theirs).abs().max().item() < 2e-4
    tok = ref.bucket_tokens(ClipBPE(77)(CAPTIONS[:8]), 32, ClipBPE(77).eot)
    theirs = ref.l2n(prog.infer_text_features(prog.params, torch.as_tensor(tok)))
    assert (mine.text_features(torch.as_tensor(tok)) - theirs).abs().max().item() < 2e-4
    # one precision below moves them far
    low = ref.ClipInt8(c, p, bits=4)
    assert (low.image_features(px) - mine.image_features(px)).abs().max().item() > 1e-2


def test_tvc_scores_equal_the_programs_plain_scoring():
    from tvc_torch.core.kernels.consistency_kernel import consistency_scores_reference

    g = torch.Generator().manual_seed(3)
    B, V, R, D = 9, 5, 3, 32
    img, txt = torch.randn(B, D, generator=g), torch.randn(B, D, generator=g)
    var, refs = torch.randn(B, V, D, generator=g), torch.randn(B, R, D, generator=g)
    vmask = torch.rand(B, V, generator=g) > 0.4
    vmask[0] = False
    ours = ref.tvc_scores(img, txt, var, vmask, refs)
    theirs = consistency_scores_reference(img, txt, var, refs, variant_mask=vmask, ref_mask=torch.ones(B, R, dtype=torch.bool))
    for k in ref.SCORE_KEYS:
        assert torch.allclose(ours[k], theirs[k], atol=1e-6), k
    assert torch.equal(ours["is_adversarial"], theirs["is_adversarial"])


def test_qwen2_w8_reference_equals_the_programs_teacher_forced_logits():
    """The program in f32 with w8 weights, teacher-forced on tokens drawn
    here, against the reference's full forward. The program's tied head
    rounds its dequantized table to bf16 (2^-9 relative per entry, ~2e-3 of
    the logits' RMS typically, ~1.2e-2 at the worst of 150,000 x 18), so
    the logits agree to 3e-2 of their RMS at worst and 4e-3 in the median,
    where a wrong rotary, norm or cache slot moves them by O(1) of it."""
    from perfbench import common
    from tvc_torch.models.qwen import PARAPHRASE_PREFIX, QwenConfig, QwenModel

    q = dict(common.config("tvc-qwen2-1.5b-w8")["qwen"])
    q.update(TINY_QWEN)
    p = weights.qwen_params(q, 5, "cpu")
    cfg = QwenConfig(vocab_size=q["vocab_size"], hidden_size=q["hidden_size"], intermediate_size=q["intermediate_size"],
                     num_layers=q["num_hidden_layers"], num_heads=q["num_attention_heads"],
                     num_kv_heads=q["num_key_value_heads"], max_seq_len=128, rope_theta=q["rope_theta"],
                     rms_eps=q["rms_norm_eps"], dtype=torch.float32)
    prog = QwenModel(cfg, params=weights.nest(p), max_new_tokens=6, device="cpu")
    prog.quantize_weights_int8()
    texts = CAPTIONS[:3]
    prompts = [qref.PARAPHRASE_PROMPT.format(text=t) for t in texts]
    inp = prog.prepare(prompts, 1, None, PARAPHRASE_PREFIX)
    forced = torch.randint(0, 150000, (6, 3), generator=torch.Generator().manual_seed(1))
    got = []
    prog.decode(inp, forced=forced, on_logits=lambda i, lg: got.append(lg.clone()))
    mine = qref.Qwen2(q, p, bits=8)
    bpe = QwenBPE()
    for r, prompt in enumerate(prompts):
        ids = bpe.encode(prompt) + forced[:-1, r].tolist()
        lg = mine.logits(ids)[len(bpe.encode(prompt)) - 1 :]
        theirs = torch.stack([g[r] for g in got])
        rms = lg.square().mean().sqrt()
        assert (lg - theirs).abs().max() < 3e-2 * rms
        assert (lg - theirs).abs().median() < 4e-3 * rms
    assert qref.topk_gaps(lg, theirs.argmax(-1).tolist(), 1).max() < 3e-2 * rms
