"""CTC prefix beam search on the device, batched, fixed-shape (counterpart of
``qasr/decode/beam.py``).

The reference searches in a ``lax.scan`` over time on the TPU; here a Python
loop over frames runs the same operations on the logits' device, batched
over utterances, with all state on the device and no host sync inside the
loop.

Per frame, W stay-candidates (prefix unchanged: blank emission + collapsed
repeat) and W*V extend-candidates compete for the next beam. Duplicates can
only pair an extend-candidate with a stay-candidate (two distinct surviving
prefixes cannot extend to the same prefix, and the stays keep distinct
prefixes). The reference merges them by a dense ``[W, V, W]`` equality of
rolling hashes and a masked logsumexp over it; here the same merge is
indexed (:func:`_merge`): extension ``(i, v)`` has beam slot j's hash
exactly when ``v`` is the one token that hash arithmetic gives for the pair
``(i, j)``, so the equality is a ``[W, W]`` table of tokens and the masked
logsumexp runs over the parents i alone. Every term the dense form adds
besides those is ``exp(NEG_INF - m) = 0``, so the two agree bit for bit
wherever a slot receives at most two extensions (the tests hold it;
receiving two already takes a hash collision). The W best by total
probability survive, chosen by a stable descending sort: ``lax.top_k``
puts the lower index first among equal values, and ``torch.topk`` promises
no order for ties, which are the rule in the first frames (every dead
candidate scores exactly ``NEG_INF``).

Hashes are the reference's 32-bit rolling hashes, carried in int64 and
wrapped at 2^32 after each multiply-add (the product stays below 2^53).
``prune_logp`` is absolute, as in the reference's code: a token whose frame
log-prob is below it never extends a prefix.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
_HASH_MULT = 1000003
_HASH_MASK = 0xFFFFFFFF
_HASH_SEED = 0x9E3779B9


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, b)
    dead = m <= NEG_INF / 2
    m_safe = torch.where(dead, 0.0, m)
    s = torch.exp(a - m_safe) + torch.exp(b - m_safe)
    s = torch.where(dead, 1.0, s)
    return torch.where(dead, NEG_INF, m_safe + torch.log(s))


def _masked_logsumexp(vals: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    """logsumexp over ``dim`` counting only ``mask`` entries (-inf elsewhere)."""
    vals = torch.where(mask, vals, NEG_INF)
    m = torch.amax(vals, dim=dim)
    dead = m <= NEG_INF / 2
    m_safe = torch.where(dead, 0.0, m)
    s = torch.sum(torch.exp(vals - m_safe.unsqueeze(dim)), dim=dim)
    s = torch.where(dead, 1.0, torch.clamp_min(s, 1e-38))
    return torch.where(dead, NEG_INF, m_safe + torch.log(s))


def _merge(ext_pnb: torch.Tensor, hashes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's merge of extend-candidates into the beam, indexed.

    ``ext_pnb`` ``[B, W, V]`` is the non-blank log-prob of prefix i + token
    v, ``hashes`` ``[B, W]`` the beam's prefix hashes. Extension ``(i, v)``
    hashes to ``(h_i * M + v + 2) mod 2^32``, which is ``h_j`` exactly for
    ``v = (h_j - h_i * M - 2) mod 2^32``: a match when that is below V.
    Returns (``[B, W]`` the masked logsumexp over the extensions matching
    each slot j, ``[B, W, V]`` the extensions matching no slot)."""
    b, w, v = ext_pnb.shape
    tok = (hashes.unsqueeze(1) - hashes.unsqueeze(2) * _HASH_MULT - 2) & _HASH_MASK  # [B, i, j]
    match = tok < v
    vals = ext_pnb.gather(2, tok.clamp_max(v - 1))                                   # [B, i, j]
    contrib = _masked_logsumexp(vals, match, dim=1)
    hit = torch.zeros((b, w, v + 1), dtype=torch.bool, device=ext_pnb.device)
    hit.scatter_(2, torch.where(match, tok, v), True)
    return contrib, ~hit[:, :, :v]


@torch.no_grad()
def ctc_beam_search_decode(
    logits: torch.Tensor,
    logit_lengths: torch.Tensor,
    *,
    beam_width: int = 16,
    blank_id: int = 0,
    max_len: int = 128,
    prune_logp: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched CTC prefix beam search on the logits' device.

    Args:
      logits: ``[B, T, V]`` unnormalized scores (any float dtype: the
        log-softmax is taken in f32).
      logit_lengths: ``[B]`` valid frame counts.
      prune_logp: if set, tokens with frame log-prob below this never extend
        a prefix (``cfg.decode.beam_prune_logp``).

    Returns:
      (sequences ``[B, max_len]`` int32 padded with -1, lengths ``[B]``
      int32, log-score ``[B]`` f32 of the best prefix), on the logits'
      device.
    """
    dev = logits.device
    b, t_total, v = logits.shape
    w = beam_width
    logp = torch.log_softmax(logits.float(), dim=-1)
    length = logit_lengths.to(dev)

    # initial beam: slot 0 = empty prefix; the others dead with distinct hashes
    prefixes = torch.full((b, w, max_len), -1, dtype=torch.int32, device=dev)
    lens = torch.zeros((b, w), dtype=torch.int32, device=dev)
    widx = torch.arange(w, device=dev)
    hashes = ((1 + widx * _HASH_SEED) & _HASH_MASK).expand(b, w).contiguous()
    p_b = torch.full((b, w), NEG_INF, device=dev)
    p_b[:, 0] = 0.0
    p_nb = torch.full((b, w), NEG_INF, device=dev)

    tokens = torch.arange(v, device=dev)
    # the candidate pool's layout: W stays, then W*V extends (parent-major)
    cand_parent = torch.cat([widx, widx.repeat_interleave(v)])
    cand_tok = torch.cat([torch.full((w,), -1, device=dev), tokens.repeat(w)]).to(torch.int32)
    neg_ext = torch.full((b, w * v), NEG_INF, device=dev)
    not_blank = tokens != blank_id

    # frames past every utterance's length change nothing (all frozen)
    t_end = min(t_total, int(length.max())) if b else 0
    for t in range(t_end):
        logp_t = logp[:, t]                                           # [B, V]
        has = lens > 0
        last = torch.where(
            has, prefixes.gather(2, (lens - 1).clamp_min(0).long().unsqueeze(2)).squeeze(2), -1
        )
        p_tot = _logaddexp(p_b, p_nb)

        # --- stay candidates (prefix unchanged) ---
        stay_pb = p_tot + logp_t[:, blank_id : blank_id + 1]
        stay_pnb = torch.where(has, p_nb + logp_t.gather(1, last.clamp_min(0).long()), NEG_INF)

        # --- extend candidates: prefix + v, v != blank ---
        base = torch.where(tokens == last.unsqueeze(2), p_b.unsqueeze(2), p_tot.unsqueeze(2))
        ext_pnb = base + logp_t.unsqueeze(1)                          # [B, W, V]
        ext_pnb = torch.where(not_blank, ext_pnb, NEG_INF)
        ext_pnb = torch.where((lens >= max_len).unsqueeze(2), NEG_INF, ext_pnb)
        if prune_logp is not None:
            ext_pnb = torch.where((logp_t < prune_logp).unsqueeze(1), NEG_INF, ext_pnb)
        ext_hash = (hashes.unsqueeze(2) * _HASH_MULT + (tokens + 2)) & _HASH_MASK

        # --- merge extend-candidates that equal an existing beam prefix ---
        contrib, ext_alive = _merge(ext_pnb, hashes)
        stay_pnb = _logaddexp(stay_pnb, contrib)
        ext_pnb = torch.where(ext_alive, ext_pnb, NEG_INF)

        # --- candidate pool: W stays + W*V extends, all unique prefixes ---
        cand_pb = torch.cat([stay_pb, neg_ext], dim=1)
        cand_pnb = torch.cat([stay_pnb, ext_pnb.reshape(b, w * v)], dim=1)
        cand_hash = torch.cat([hashes, ext_hash.reshape(b, w * v)], dim=1)
        total = _logaddexp(cand_pb, cand_pnb)

        sel = torch.sort(total, dim=1, descending=True, stable=True).indices[:, :w]
        parent = cand_parent[sel]
        tok = cand_tok[sel]
        new_prefixes = prefixes.gather(1, parent.unsqueeze(2).expand(b, w, max_len))
        new_lens = lens.gather(1, parent)
        extend = tok >= 0
        pos = new_lens.clamp_max(max_len - 1).long().unsqueeze(2)
        cur = new_prefixes.gather(2, pos).squeeze(2)
        new_prefixes.scatter_(2, pos, torch.where(extend, tok, cur).unsqueeze(2))
        new_lens = new_lens + extend.to(torch.int32)

        # freeze past the utterance's last frame
        active = (t < length).unsqueeze(1)
        prefixes = torch.where(active.unsqueeze(2), new_prefixes, prefixes)
        lens = torch.where(active, new_lens, lens)
        hashes = torch.where(active, cand_hash.gather(1, sel), hashes)
        p_b = torch.where(active, cand_pb.gather(1, sel), p_b)
        p_nb = torch.where(active, cand_pnb.gather(1, sel), p_nb)

    scores = _logaddexp(p_b, p_nb)
    best = torch.argmax(scores, dim=1)                                # first maximum
    rows = torch.arange(b, device=dev)
    return prefixes[rows, best], lens[rows, best], scores[rows, best]
