"""Speculative decoding: draft sources + multi-token verification.

A draft source proposes k cheap tokens per request; the target model scores
the whole window in ONE multi-token decode pass (the flash-decode kernel
grown to a block of draft rows, ``kernels.flash_attention.
flash_decode_spec{,_paged}``); the verifier accepts a prefix and emits one
extra token — greedy mode is token-identical to non-speculative decoding,
sampled mode is distribution-faithful rejection sampling against the
engine's per-request PRNG streams (``repro_torch.prng``, JAX's own).
"""
from repro_torch.spec.draft import (DraftSource, ModelDraft, NGramDraft,
                                    build_draft_source)
from repro_torch.spec.verify import greedy_verify, rejection_verify

__all__ = ["DraftSource", "ModelDraft", "NGramDraft", "build_draft_source",
           "greedy_verify", "rejection_verify"]
