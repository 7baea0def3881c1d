"""Object-condensation loss (Kieseler, arXiv:2002.03605) for CaloClusterNet.

Counterpart of ``repro/core/condensation.py``, in torch ops, batched
over events. Per-hit labels: ``object_id`` ∈ {-1 (noise), 0..K-1} and
per-hit truth (energy, class). Charges q_i = arctanh²(β_i) + q_min; each
object k is represented by its highest-charge hit α_k. Losses:

  L_V    = mean_i q_i [Σ_k M_ik · V_att(i,α_k) + (1-M_ik) · V_rep(i,α_k)]
           with V_att = d²·q_αk, V_rep = max(0, 1-d)·q_αk
  L_beta = mean_k (1 - β_αk)  +  s_B · mean_{noise} β_i
  L_E    = masked Huber on per-hit energy at object hits
  L_cls  = masked cross-entropy at object hits

Differentiable with autograd; the warm-training of
``launch/serve.py`` backpropagates through it.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class CondensationWeights:
    q_min: float = 0.1
    s_beta_noise: float = 1.0
    w_potential: float = 1.0
    w_beta: float = 1.0
    w_energy: float = 0.2
    w_cls: float = 0.2


def condensation_loss(outputs, labels, mask, *, k_max: int,
                      w: CondensationWeights = CondensationWeights()):
    """outputs: ``CaloClusterNet`` outputs (B,N,...); labels:
    {'object_id' (B,N) int, 'energy' (B,N), 'cls' (B,N) int}; mask (B,N).
    Returns (loss, metrics), each a 0-dim f32 tensor."""
    mask = mask.float()
    beta = torch.sigmoid(outputs["beta_logit"]) * mask
    beta = torch.clamp(beta, 1e-6, 1.0 - 1e-6)
    coords = outputs["coords"]
    obj = labels["object_id"].long()
    is_hit = (obj >= 0) & (mask > 0)
    is_noise = (obj < 0) & (mask > 0)

    q = torch.atanh(beta) ** 2 + w.q_min                       # (B,N)
    # one-hot membership M (B, N, K)
    ks = torch.arange(k_max, device=obj.device)
    m = (obj[..., None] == ks) & is_hit[..., None]
    obj_exists = m.any(dim=1)                                   # (B,K)
    # alpha_k = argmax_i q_i within object k (the first on ties)
    q_masked = torch.where(m, q[..., None], -1.0)
    alpha = torch.argmax(q_masked, dim=1)                       # (B,K)
    xy_a = torch.gather(coords, 1, alpha[..., None].expand(-1, -1, 2))
    q_a = torch.gather(q, 1, alpha) * obj_exists                # (B,K)
    b_a = torch.gather(beta, 1, alpha)
    d = torch.linalg.vector_norm(
        coords[:, :, None, :] - xy_a[:, None, :, :] + 1e-9, dim=-1)
    v_att = (d ** 2) * q_a[:, None, :]
    v_rep = torch.clamp_min(1.0 - d, 0.0) * q_a[:, None, :]
    mf = m.float()
    active = (is_hit | is_noise).float()
    pot = (mf * v_att + (1.0 - mf) * v_rep
           * obj_exists[:, None, :]).sum(dim=2) * q * active
    l_v = pot.sum(dim=1) / torch.clamp_min(active.sum(dim=1), 1.0)
    n_obj = torch.clamp_min(obj_exists.sum(dim=1).float(), 1.0)
    noise_f = is_noise.float()
    l_beta = (((1.0 - b_a) * obj_exists).sum(dim=1) / n_obj
              + w.s_beta_noise * (beta * noise_f).sum(dim=1)
              / torch.clamp_min(noise_f.sum(dim=1), 1.0))

    # energy (Huber) + class CE at object hits
    hit_f = is_hit.float()
    e_err = outputs["energy"] - labels["energy"]
    huber = torch.where(e_err.abs() < 1.0, 0.5 * e_err ** 2,
                        e_err.abs() - 0.5)
    n_hit = torch.clamp_min(hit_f.sum(), 1.0)
    l_e = (huber * hit_f).sum() / n_hit
    logp = torch.log_softmax(outputs["cls_logits"], dim=-1)
    cls = torch.clamp_min(labels["cls"].long(), 0)
    ce = -torch.gather(logp, -1, cls[..., None])[..., 0]
    l_cls = (ce * hit_f).sum() / n_hit

    loss = (w.w_potential * l_v.mean() + w.w_beta * l_beta.mean()
            + w.w_energy * l_e + w.w_cls * l_cls)
    metrics = {"loss": loss, "l_potential": l_v.mean(),
               "l_beta": l_beta.mean(), "l_energy": l_e, "l_cls": l_cls}
    return loss, metrics
