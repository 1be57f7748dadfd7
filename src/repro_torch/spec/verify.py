"""Accept/rollback verdicts for speculative windows.

The verifier consumes the (B, S, V) logits of one multi-token verify pass
over the window [last_emitted, d_1, .., d_{S-1}]: row qi is the target
model's next-token distribution after window position qi, so row 0 scores
draft d_1 and row S-1 is the bonus distribution past the last draft.

Both verifiers return ``(tokens, n_emit)`` where ``tokens[b, :n_emit[b]]``
are the tokens to emit for row b (1 <= n_emit <= S): the accepted draft
prefix plus exactly one non-draft token (greedy argmax / residual resample
/ bonus). Both run where the logits are, with no host round trip.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import prng
from repro_torch.launch.sampling import sample_probs


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


def rejection_verify(logits, drafts, draft_probs: Optional[torch.Tensor],
                     keys, *, temperature: float, top_k: int = 0):
    """Distribution-faithful speculative sampling (accept/resample).

    logits: (B, S, V) target logits; drafts: (B, S-1) proposed tokens;
    draft_probs: (B, S-1, V) proposal distributions, or None for
    deterministic proposals (one-hot — the n-gram head and greedy model
    drafts); keys: (B, S, 2) int64 — the engine's fold_in(seed, uid, index)
    stream keys for the S candidate emission indices, so a request's
    randomness stays batch-composition independent.

    Draft d_i is accepted with probability min(1, q_i(d_i) / p_i(d_i))
    where q is the target distribution under the SHARED temperature/top-k
    masking (repro_torch.launch.sampling — the same shaping the engine's
    sampler uses). On first rejection the token resamples from the residual
    norm(max(q - p, 0)); if every draft survives, the bonus position samples
    from q directly. Marginally, every emitted token ~ q exactly. The
    uniforms are ``uniform(fold_in(k, 0))`` and the resamples
    ``categorical(fold_in(k, 1), ·)`` of each window key k, as the
    reference draws them.
    """
    q = sample_probs(logits, temperature, top_k)               # (B, S, V)
    B, S, V = q.shape
    dev = q.device
    keys = torch.as_tensor(keys, device=dev)
    u = prng.uniform(prng.fold_in(keys, 0))                    # (B, S)
    r_keys = prng.fold_in(keys, 1)

    if S > 1:
        d = torch.as_tensor(drafts, device=dev).long()         # (B, S-1)
        qd = torch.gather(q[:, :-1], -1, d[..., None])[..., 0]
        if draft_probs is None:
            # deterministic proposal: p(d) = 1, residual = q with d zeroed
            pd = torch.ones_like(qd)
            onehot = torch.nn.functional.one_hot(d, V).to(q.dtype)
            resid = torch.clamp_min(q[:, :-1] - onehot * qd[..., None], 0.0)
        else:
            p = torch.as_tensor(draft_probs, device=dev).float()
            pd = torch.gather(p, -1, d[..., None])[..., 0]
            resid = torch.clamp_min(q[:, :-1] - p, 0.0)
        # u < min(1, qd/pd) without dividing: u*pd < qd (pd = 0 rejects
        # unless qd > 0, which accepts — the proposal was impossible anyway)
        ok = (u[:, :-1] * pd < qd).to(torch.int32)
        n_acc = torch.cumprod(ok, dim=1).sum(dim=1).to(torch.int32)
        total = resid.sum(-1, keepdim=True)
        resid = torch.where(total > 0, resid / torch.clamp_min(total, 1e-30),
                            q[:, :-1])
        fb_probs = torch.cat([resid, q[:, -1:]], dim=1)        # (B, S, V)
    else:
        n_acc = torch.zeros((B,), dtype=torch.int32, device=dev)
        fb_probs = q

    fb_logits = torch.where(fb_probs > 0, torch.log(fb_probs),
                            float("-inf"))
    fallback = prng.categorical(r_keys, fb_logits).to(torch.int32)  # (B, S)

    pos = torch.arange(S, dtype=torch.int32, device=dev)[None]
    dpad = torch.zeros((B, S), dtype=torch.int32, device=dev)
    if S > 1:
        dpad[:, :-1] = d.to(torch.int32)
    tokens = torch.where(pos < n_acc[:, None], dpad, fallback)
    return tokens, n_acc + 1
