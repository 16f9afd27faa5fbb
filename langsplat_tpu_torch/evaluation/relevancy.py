"""Open-vocabulary relevancy scoring (LERF-style), PyTorch counterpart of
`langsplat_tpu/evaluation/relevancy.py`.

For each query embedding, pair the positive phrase's similarity with each canonical
negative ("object", "things", "stuff", "texture"), take softmax(10 * [pos, neg]) per
pair, and keep the pair whose positive probability is LOWEST (the most adversarial
negative; the first on ties). The products run in float32 (no TF32, see
`device.float32_matmul_highest`): the maps feed a temperature-10 softmax and a 0.4
threshold.
"""

from __future__ import annotations

import torch

NEGATIVE_PROMPTS = ("object", "things", "stuff", "texture")
RELEVANCY_TEMPERATURE = 10.0


def _pairs_to_relevancy(pos_sim: torch.Tensor, neg_sim: torch.Tensor) -> torch.Tensor:
    """[N] positive and [N, M] negative similarities -> [N, 2] (pos_prob, neg_prob)."""
    pairs = torch.stack([pos_sim[:, None].expand_as(neg_sim), neg_sim], dim=-1)
    probs = torch.softmax(RELEVANCY_TEMPERATURE * pairs, dim=-1)      # [N, M, 2]
    worst = torch.argmin(probs[..., 0], dim=1)                        # [N]
    return torch.gather(probs, 1, worst[:, None, None].expand(-1, 1, 2))[:, 0, :]


def relevancy(embeds: torch.Tensor, pos_embed: torch.Tensor,
              neg_embeds: torch.Tensor) -> torch.Tensor:
    """[N, D] embeds, [D] positive, [M, D] negatives -> [N, 2] (pos_prob, neg_prob) for
    the most adversarial negative."""
    return _pairs_to_relevancy(embeds @ pos_embed, embeds @ neg_embeds.T)


def get_max_across(sem_map: torch.Tensor, pos_embeds: torch.Tensor,
                   neg_embeds: torch.Tensor) -> torch.Tensor:
    """[L, H, W, D] feature maps + [P, D] positives -> [L, P, H, W] relevancy maps.

    One [L*H*W, D] x [D, P+M] product gives every similarity; the softmax and the
    choice of negative then run per prompt on [L*H*W, M] columns, so the feature maps
    are read once whatever the number of prompts."""
    l, h, w, d = sem_map.shape
    p = pos_embeds.shape[0]
    sims = sem_map.reshape(-1, d) @ torch.cat([pos_embeds, neg_embeds]).T   # [LHW, P+M]
    neg_sim = sims[:, p:]
    out = torch.stack([_pairs_to_relevancy(sims[:, k], neg_sim)[:, 0] for k in range(p)])
    return out.reshape(p, l, h, w).transpose(0, 1)


def semantic_map(sem_map: torch.Tensor, semantic_embeds: torch.Tensor,
                 neg_embeds: torch.Tensor) -> torch.Tensor:
    """[L, H, W, D] -> [L, H, W] argmax semantic ids, -1 where a negative wins."""
    l, h, w, d = sem_map.shape
    phrases = torch.cat([semantic_embeds, neg_embeds])
    logits = sem_map.reshape(l, h * w, d) @ phrases.T
    pred = torch.argmax(torch.softmax(RELEVANCY_TEMPERATURE * logits, dim=-1), dim=-1)
    pred = torch.where(pred >= semantic_embeds.shape[0], -1, pred)
    return pred.reshape(l, h, w)
