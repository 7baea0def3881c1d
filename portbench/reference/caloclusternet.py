"""Plain PyTorch reference of CaloClusterNet as the mixed deployment runs it.

It imports nothing of the program. From the weights, the calibration events
and the traffic that the benchmark makes from the seed, it works out again
what the deployment derives at set-up: the activation scales of a float32
calibration pass, the per-channel int8 weights, and the int8 forward of the
design flow's mixed policy, then CPS.

The mixed policy, as deployed at design point 3:

- the encoder's first dense quantizes the raw hits at scale 1.0 (the design
  flow records no max-abs for an input), the second reads the first's int8
  output;
- each GravNet block quantizes its float32 input with its producer's scale,
  takes S and F from exact int8 sums, aggregates the k nearest neighbours in
  float32, snaps the aggregate to its own grid, quantizes concat(x, agg) and
  runs the int8 output dense with ReLU;
- the decoder's denses and the merged heads read int8 activations (each
  dense's output requantized with its own scale), and the heads come out in
  float32;
- CPS on the heads.

A scale is max(max-abs, 1e-8) / qmax of the float32 calibration pass over the
calibration events, with qmax = 127 (int8) or 7 (int4, the control). A
quantization is round-half-to-even of an IEEE division, clipped to +-qmax.
Integer sums are exact here in float32 (all partial sums stay below 2^24),
with TF32 off.
"""
from __future__ import annotations

import numpy as np
import torch

BIG = 1e30
HEADS = (("beta", 1), ("coords", 2), ("energy", 1), ("cls", None))


def f32(v: float) -> float:
    return float(np.float32(v))


def head_dims(cfg: dict) -> dict:
    return {h: (cfg["n_classes"] if d is None else d) for h, d in HEADS}


def param_shapes(cfg: dict) -> dict:
    """{dense name: (d_in, d_out)}, the program's layout and naming."""
    dh, ds, df = cfg["d_hidden"], cfg["d_s"], cfg["d_flr"]
    shapes = {"enc1": (cfg["d_in"], dh), "enc2": (dh, dh)}
    for i in range(cfg["n_gravnet_blocks"]):
        shapes[f"gn{i}_s"] = (dh, ds)
        shapes[f"gn{i}_flr"] = (dh, df)
        shapes[f"gn{i}_out"] = (dh + 2 * df, dh)
    shapes["dec1"] = (dh, dh)
    shapes["dec2"] = (dh, cfg["d_decoder"])
    for h, d in head_dims(cfg).items():
        shapes[f"head_{h}"] = (cfg["d_decoder"], d)
    return shapes


def make_params(cfg: dict, weights: dict, seed: int, device) -> dict:
    """Every dense's {"w": (d_in, d_out), "b": (d_out,)} from ``seed`` on
    ``device``, in two draws of one generator: LeCun-normal weights and
    normal biases of std ``weights["b_std"]``."""
    shapes = param_shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    nw = sum(a * b for a, b in shapes.values())
    nb = sum(b for _, b in shapes.values())
    wflat = torch.randn(nw, generator=gen, device=device)
    bflat = torch.randn(nb, generator=gen, device=device) * weights["b_std"]
    params, iw, ib = {}, 0, 0
    for name, (a, b) in shapes.items():
        params[name] = {"w": wflat[iw:iw + a * b].view(a, b) / a ** 0.5,
                        "b": bflat[ib:ib + b].clone()}
        iw += a * b
        ib += b
    return params


# ------------------------------------------------------------ quantizers ----
def act_scale(absmax: float, qmax: int) -> float:
    return max(float(absmax), 1e-8) / qmax


def quantize(v, scale: float, qmax: int):
    """Integer values (as float32) of ``v`` on the grid of ``scale``."""
    q = torch.round(v.float() / torch.full((), f32(scale), device=v.device))
    return torch.clamp(q, -qmax, qmax)


def quantize_weight(w, qmax: int):
    """Per output channel: (integer w, float32 scale (d_out,))."""
    scale = torch.clamp_min(w.abs().amax(dim=0), f32(1e-8)) / qmax
    return torch.clamp(torch.round(w / scale[None, :]), -qmax, qmax), scale


def int_dense(xq, wq, b, x_scale: float, w_scale):
    """Exact integer sums, dequantized: acc * (x_scale * w_scale) + b."""
    acc = xq @ wq
    return acc * (f32(x_scale) * w_scale) + b


# ---------------------------------------------------------------- GravNet ----
def aggregate(s, f, mask, k: int, scale: float):
    """GravNet's aggregation over each event: for every row, the k valid
    rows of its own event nearest in S (d2 = |s_i|^2 + |s_j|^2 - 2 s_i.s_j,
    clamped at 0; ties to the lowest row), weights exp(-scale * d2), the
    mean over k slots and the max over the filled ones (0 where none).
    s:(B,n,ds), f:(B,n,df), mask:(B,n) -> (B,n,2 df)."""
    bsz, n, ds = s.shape
    dot = torch.zeros((bsz, n, n), dtype=torch.float32, device=s.device)
    sq = torch.zeros((bsz, n), dtype=torch.float32, device=s.device)
    for d in range(ds):
        dot = dot + s[:, :, d, None] * s[:, None, :, d]
        sq = sq + s[:, :, d] * s[:, :, d]
    d2 = torch.clamp_min(sq[:, :, None] + sq[:, None, :] - 2.0 * dot, 0.0)
    eye = torch.eye(n, dtype=torch.bool, device=s.device)
    d2 = torch.where((mask[:, None, :] <= 0) | eye, BIG, d2)
    d2k, idx = torch.sort(d2, dim=2, stable=True)
    d2k, idx = d2k[..., :k], idx[..., :k]
    valid = d2k < BIG * 0.5
    w = torch.where(valid, torch.exp(-scale * d2k), 0.0)
    df = f.shape[2]
    fk = torch.gather(f, 1, idx.reshape(bsz, n * k, 1).expand(-1, -1, df))
    wf = w[..., None] * fk.reshape(bsz, n, k, df)
    mean = torch.where(valid[..., None], wf, 0.0).sum(dim=2) / f32(k)
    mx = torch.where(valid[..., None], wf, -BIG).amax(dim=2)
    mx = torch.where(mx <= -BIG * 0.5, 0.0, mx)
    return torch.cat([mean, mx], dim=2)


# --------------------------------------------------------------- forwards ----
def _dense(p, x, relu=True):
    y = x @ p["w"] + p["b"]
    return torch.relu(y) if relu else y


def _heads_params(params, cfg):
    names = [f"head_{h}" for h in head_dims(cfg)]
    return {"w": torch.cat([params[n]["w"] for n in names], dim=1),
            "b": torch.cat([params[n]["b"] for n in names])}


def _split_heads(y, cfg):
    out, c = {}, 0
    for h, d in head_dims(cfg).items():
        out[h] = y[..., c:c + d]
        c += d
    return out


def calibrate(params, hits, mask, cfg: dict, qmax: int) -> dict:
    """The scales and quantized weights of the mixed deployment, from one
    float32 pass over the calibration events."""
    absmax = {}

    def rec(name, v):
        absmax[name] = v.abs().max().item()
        return v

    x = rec("enc1", _dense(params["enc1"], hits))
    x = rec("enc2", _dense(params["enc2"], x))
    for i in range(cfg["n_gravnet_blocks"]):
        s = _dense(params[f"gn{i}_s"], x, relu=False)
        f = _dense(params[f"gn{i}_flr"], x, relu=False)
        agg = rec(f"gn{i}_agg", aggregate(s, f, mask, cfg["k"],
                                          cfg["potential_scale"]))
        h = rec(f"gn{i}_h", torch.cat([x, agg], dim=-1))
        x = rec(f"gn{i}", _dense(params[f"gn{i}_out"], h))
    x = rec("dec1", _dense(params["dec1"], x))
    x = rec("dec2", _dense(params["dec2"], x))
    y = _dense(_heads_params(params, cfg), x, relu=False)
    rec("heads", y)
    for h, v in _split_heads(y, cfg).items():
        rec(f"head_{h}", v)
    scales = {n: act_scale(a, qmax) for n, a in absmax.items()}
    qw = {}
    dense_names = ["enc1", "enc2", "dec1", "dec2"] + [
        f"gn{i}_{p}" for i in range(cfg["n_gravnet_blocks"])
        for p in ("s", "flr", "out")]
    for n in dense_names:
        qw[n] = quantize_weight(params[n]["w"], qmax)
    qw["heads"] = quantize_weight(_heads_params(params, cfg)["w"], qmax)
    return {"scales": scales, "qw": qw, "qmax": qmax}


def forward_mixed(params, cal, hits, mask, cfg: dict) -> dict:
    """The heads of the mixed deployment: {beta (B,N,1), coords (B,N,2),
    energy (B,N,1), cls (B,N,n_classes)} in float32."""
    sc, qw, qmax = cal["scales"], cal["qw"], cal["qmax"]

    def dense(name, xq, x_scale, relu=True, p=None):
        p = params[name] if p is None else p
        wq, ws = qw[name]
        y = int_dense(xq, wq, p["b"], x_scale, ws)
        return torch.relu(y) if relu else y

    q = quantize(hits, 1.0, qmax)
    y = dense("enc1", q, 1.0)
    y = dense("enc2", quantize(y, sc["enc1"], qmax), sc["enc1"])
    x_scale = sc["enc2"]
    for i in range(cfg["n_gravnet_blocks"]):
        xq = quantize(y, x_scale, qmax)
        s = dense(f"gn{i}_s", xq, x_scale, relu=False)
        f = dense(f"gn{i}_flr", xq, x_scale, relu=False)
        agg = aggregate(s, f, mask, cfg["k"], cfg["potential_scale"])
        a_sc = f32(sc[f"gn{i}_agg"])
        agg = torch.clamp(torch.round(agg / torch.full(
            (), a_sc, device=agg.device)), -qmax, qmax) * a_sc
        h_scale = sc[f"gn{i}_h"]
        hq = quantize(torch.cat([y, agg], dim=-1), h_scale, qmax)
        y = dense(f"gn{i}_out", hq, h_scale)
        x_scale = sc[f"gn{i}"]
    y = dense("dec1", quantize(y, x_scale, qmax), x_scale)
    y = dense("dec2", quantize(y, sc["dec1"], qmax), sc["dec1"])
    y = dense("heads", quantize(y, sc["dec2"], qmax), sc["dec2"],
              relu=False, p=_heads_params(params, cfg))
    return _split_heads(y, cfg)


def cps(heads: dict, mask, cfg: dict) -> dict:
    """Condensation point selection: walk each event's hits in decreasing
    beta = sigmoid(logit) * mask (ties in hit order) and take a hit whose
    beta exceeds t_beta and that lies farther than t_dist (in the coords
    head's plane) from every hit taken, until k_max are taken; the trigger
    fires when a taken hit's energy exceeds e_trigger."""
    beta = torch.sigmoid(heads["beta"][..., 0].float()) * mask
    coords = heads["coords"].float()
    energy = heads["energy"][..., 0].float()
    bsz, n = beta.shape
    kmax = cfg["k_max"]
    dev = beta.device
    order = torch.argsort(-beta, dim=1, stable=True)
    b_s = torch.gather(beta, 1, order)
    c_s = torch.gather(coords, 1, order[..., None].expand(bsz, n, 2))
    e_s = torch.gather(energy, 1, order)
    t_beta = torch.tensor(cfg["t_beta"], dtype=torch.float32)
    thr = torch.tensor(cfg["t_dist"] ** 2, dtype=torch.float32)
    xy = torch.zeros((bsz, kmax, 2), dtype=torch.float32, device=dev)
    e = torch.zeros((bsz, kmax), dtype=torch.float32, device=dev)
    b = torch.zeros((bsz, kmax), dtype=torch.float32, device=dev)
    valid = torch.zeros((bsz, kmax), dtype=torch.bool, device=dev)
    count = torch.zeros(bsz, dtype=torch.long, device=dev)
    rows = torch.arange(bsz, device=dev)
    for p in range(n):
        cp = c_s[:, p]
        d2 = ((xy - cp[:, None, :]) ** 2).sum(dim=2)
        blocked = (valid & (d2 <= thr)).any(dim=1)
        take = (b_s[:, p] > t_beta) & ~blocked & (count < kmax)
        slot = torch.clamp_max(count, kmax - 1)
        r, sl = rows[take], slot[take]
        xy[r, sl] = cp[take]
        e[r, sl] = e_s[take, p]
        b[r, sl] = b_s[take, p]
        valid[r, sl] = True
        count = count + take.long()
    trigger = (valid & (e > torch.tensor(cfg["e_trigger"]))).any(dim=1)
    return {"cluster_xy": xy, "cluster_e": e, "cluster_beta": b,
            "cluster_valid": valid, "n_clusters": count.to(torch.int32),
            "trigger": trigger}


def answers(params, cal, hits, mask, cfg: dict, block: int = 512) -> dict:
    """Heads and CPS of every event, computed ``block`` events at a time,
    as numpy arrays on the host."""
    parts = []
    for s in range(0, hits.shape[0], block):
        h, m = hits[s:s + block], mask[s:s + block]
        heads = forward_mixed(params, cal, h, m, cfg)
        out = {k: v.cpu().numpy() for k, v in heads.items()}
        out["cps"] = {k: v.cpu().numpy()
                      for k, v in cps(heads, m, cfg).items()}
        parts.append(out)
    return {k: ({kk: np.concatenate([p[k][kk] for p in parts])
                 for kk in parts[0][k]} if isinstance(parts[0][k], dict)
                else np.concatenate([p[k] for p in parts]))
            for k in parts[0]}


# ------------------------------------------------------------- comparison ----
def answer_gaps(got: dict, want: dict, cal: dict, cfg: dict):
    """Per event: the widest gap of any head value, or of any taken
    cluster's coords, energy or beta, in steps of that head's int8 grid (its
    calibration max-abs / 127), and whether CPS's decisions (trigger,
    n_clusters, cluster_valid) agree exactly. Returns (gap_steps (E,),
    decisions_agree (E,))."""
    sc = cal["scales"]
    qmax = cal["qmax"]
    step = {h: sc[f"head_{h}"] * qmax / 127.0 for h in head_dims(cfg)}
    gap = np.zeros(len(want["beta"]), np.float64)

    def widen(g, s):
        flat = np.abs(g.astype(np.float64)).reshape(len(gap), -1)
        return np.maximum(gap, flat.max(axis=1) / s)

    for h in head_dims(cfg):
        gap = widen(got[h] - want[h], step[h])
    gc, wc = got["cps"], want["cps"]
    valid = wc["cluster_valid"]
    same = ((gc["trigger"] == wc["trigger"])
            & (gc["n_clusters"] == wc["n_clusters"])
            & (gc["cluster_valid"] == valid).all(axis=1))
    both = valid & gc["cluster_valid"]
    gap = widen(np.where(both[..., None], gc["cluster_xy"] - wc["cluster_xy"],
                         0.0), step["coords"])
    gap = widen(np.where(both, gc["cluster_e"] - wc["cluster_e"], 0.0),
                step["energy"])
    gap = widen(np.where(both, gc["cluster_beta"] - wc["cluster_beta"], 0.0),
                step["beta"])
    return gap, same
