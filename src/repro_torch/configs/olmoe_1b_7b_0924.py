"""OLMoE-1B-7B as published [hf:allenai/OLMoE-1B-7B-0924; arXiv:2409.02060].

The widths of ``olmoe_1b_7b`` (16L d_model=2048 16H kv=16 hd 128, 64
routed experts of width 1024, top-8, no shared experts, vocab 50304) with
the published model's three points where the JAX reference's rendering
departs: QK-norm as one RMSNorm over the whole q (k) projection,
``norm_topk_prob`` false (the top-8 gates are the softmax over all 64
router logits, not renormalised) and ``rms_norm_eps`` 1e-5.  rope_theta
1e4.  Rotary pairs adjacent dims, as every port config does.
"""
import dataclasses

from .olmoe_1b_7b import CONFIG as _REFERENCE, SMOKE as _REFERENCE_SMOKE

_PUBLISHED = dict(name="olmoe-1b-7b-0924", qk_norm_whole=True,
                  norm_topk_prob=False, norm_eps=1e-5, rope_theta=1e4)

CONFIG = dataclasses.replace(_REFERENCE, **_PUBLISHED)

SMOKE = dataclasses.replace(_REFERENCE_SMOKE, **_PUBLISHED)
