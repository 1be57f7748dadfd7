"""Accept/rollback verdicts for speculative windows.

The verifier consumes the (B, S, V) logits of one multi-token verify pass
over the window [last_emitted, d_1, .., d_{S-1}]: row qi is the target
model's next-token distribution after window position qi, so row 0 scores
draft d_1 and row S-1 is the bonus distribution past the last draft.

It returns ``(tokens, n_emit)`` where ``tokens[b, :n_emit[b]]`` are the
tokens to emit for row b (1 <= n_emit <= S): the accepted draft prefix plus
exactly one non-draft token. Only greedy verification is ported; the
reference's ``rejection_verify`` (sampled serving) is not.
"""
from __future__ import annotations

import torch


def greedy_verify(logits, drafts):
    """Greedy acceptance: token-identical to non-speculative argmax decode.

    logits: (B, S, V); drafts: (B, S-1) int draft tokens d_1..d_{S-1}.

    Draft d_i is accepted iff it equals the argmax after window position
    i-1; the emitted token at every position — accepted draft or first
    mismatch — is that position's argmax, so the emitted stream is exactly
    the chain a one-token-at-a-time greedy decode would produce. Ties go to
    the first maximum, as ``jnp.argmax`` breaks them.
    """
    best = logits.argmax(-1).to(torch.int32)                   # (B, S)
    B, S = best.shape
    if S > 1:
        drafts = torch.as_tensor(drafts, device=best.device).to(torch.int32)
        ok = (drafts == best[:, :-1]).to(torch.int32)
        n_acc = torch.cumprod(ok, dim=1).sum(dim=1).to(torch.int32)
    else:
        n_acc = torch.zeros((B,), dtype=torch.int32, device=best.device)
    return best, n_acc + 1
