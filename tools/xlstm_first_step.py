"""Why xlstm-1.3b's straight second AdamW step differs between one card and
a (1, 2) mesh at full width while its first agrees: ``chip_smoke.py``
``train_dist``'s xlstm config (8 layers, float32, remat, the chunkwise
mLSTM), its parity weights and batches, on one card.

  * S: the single-device run's state after its first step (and the same
    run again, compared bit for bit); P1, P2: the single run from its
    weights times (1 + 1e-7 N(0, 1)), two draws: a float32-sized control;
  * T: a gloo world of 2 on the card, mesh (1, 2), its state after the
    first step gathered to full;
  * per leaf, T's and the controls' first (clipped) gradients against S's
    (the largest difference over the leaf's largest entry), their
    first-step parameters where AdamW's step is not near sign(g)
    (``chip_smoke.py``'s rule), and the entries whose first moment
    changed sign;
  * the second step's loss and grad norm (the single model, batch 1) at
    S, T and P1, at S with T's near-sign(g) entries and at T with S's,
    and at S and T with those entries set back to their initial values
    (what ``train_dist`` holds); at each, per mLSTM layer, how close the
    normalizer max(|q.n|, e^-m) comes to its tie (the smallest
    |log(|q.n| e^m)|) and how many of its entries are floored.

Run on a machine with the card, from the repository's root:

    python3 tools/xlstm_first_step.py --out results.json

It starts its own world (``dist.launcher``, this file as ``--rank``) and
writes one JSON object.
"""
import argparse
import json
import math
import pathlib
import shutil
import subprocess
import sys
import tempfile

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))

ARCH = "xlstm-1.3b"
CONTROL_EPS, CONTROL_SEEDS = 1e-7, (7, 8)


def _trainer(c, torch, mesh, dev, tmp, eps=0.0, seed=0):
    t = c.train_dist_trainer(c.train_dist_family_cfg(ARCH), mesh, dev,
                             str(tmp / "ckpt"))
    params, opt, _ = t.init_state()
    c.parity_weights(torch, t, params)
    if eps:
        gen = torch.Generator(device=t.device).manual_seed(seed)
        with torch.no_grad():
            for p in params.values():
                p.mul_(1 + eps * torch.randn(p.shape, generator=gen,
                                             device=p.device))
    return t, params, opt


def _step(c, torch, t, opt, i):
    b = c.train_dist_family_batch(torch, t.cfg, i, t.device)
    opt, m = t.train_step(opt, b)
    return opt, [float(m["loss"]), float(m["grad_norm"])]


def _first(c, torch, t, params, opt):
    """Two steps; the parameters and first moments after the first."""
    opt, m0 = _step(c, torch, t, opt, 0)
    state = {k: (params[k].detach().clone(), opt.m[k].clone())
             for k in params}
    _, m1 = _step(c, torch, t, opt, 1)
    return state, [m0, m1]


def rank_main(tmp: pathlib.Path):
    import numpy as np
    import torch

    import chip_smoke as c
    from repro_torch.dist import bootstrap, faults
    from repro_torch.models import lm, transformer
    from repro_torch.runtime.trainer import gathered
    ctx = bootstrap.initialize(backend="gloo", device=None, timeout_s=300)
    t, params, opt = _trainer(c, torch, bootstrap.make_dist_mesh(1, 2),
                              None, tmp)
    opt, m0 = _step(c, torch, t, opt, 0)
    defs = lm.param_defs(t.cfg)
    trees = {"p": gathered(defs, {k: p.detach() for k, p in params.items()},
                           t.model.layout),
             "m": gathered(defs, opt.m, t.model.layout)}
    if ctx.process_id == 0:
        for k in params:
            parts = k.split(".")
            i = int(parts.pop(1)) if parts[0] in transformer.STACKED \
                else None
            for suf, tree in trees.items():
                node = tree
                for p in parts:
                    node = node[p]
                np.save(tmp / f"T.{k}.{suf}.npy",
                        node if i is None else node[i])
    del trees
    _, m1 = _step(c, torch, t, opt, 1)
    if ctx.process_id == 0:
        (tmp / "world.json").write_text(json.dumps([m0, m1]))
    faults.guarded_barrier("xlstm-first-step-exit", timeout_s=300)
    bootstrap.shutdown()


def normalizer_ties(torch, xlstm, q, k, i_pre, f_pre, state, chunk):
    """The chunkwise mLSTM's log(|q.n| e^m) at every position and head
    (``xlstm._mlstm_chunkwise``'s formulas for the normalizer's two
    sides, without the numerator)."""
    k = k / math.sqrt(q.shape[-1])
    _, n_in, m_in = state
    L = chunk
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    out = []
    for c in range(q.shape[1] // L):
        sl = slice(c * L, (c + 1) * L)
        qb, kb, ib = q[:, sl], k[:, sl], i_pre[:, sl]
        b = torch.cumsum(xlstm._log_sigmoid(f_pre[:, sl]), dim=1)
        run = torch.cummax(ib - b, dim=1).values
        m = b + torch.maximum(m_in[:, None, :], run)
        logD = (b[:, :, None, :] - b[:, None, :, :] + ib[:, None, :, :]
                - m[:, :, None, :])
        logD = torch.where(tri[None, :, :, None], logD, xlstm._NEG)
        qn = (torch.exp(b + m_in[:, None, :] - m)
              * torch.einsum("bjhd,bhd->bjh", qb, n_in)
              + (torch.einsum("bjhd,blhd->bjlh", qb, kb)
                 * torch.exp(logD)).sum(dim=2))
        out.append(qn.abs().log() + m)
        m_out = b[:, -1] + torch.maximum(m_in, run[:, -1])
        w = torch.exp(b[:, -1:] - b + ib - m_out[:, None])
        n_in = (torch.exp(b[:, -1] + m_in - m_out)[..., None] * n_in
                + torch.einsum("blh,blhd->bhd", w, kb))
        m_in = m_out
    return torch.cat(out, dim=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    import numpy as np
    import torch

    import chip_smoke as c
    from repro_torch.dist import launcher
    from repro_torch.models import lm, xlstm
    dev = torch.device("cuda", 0)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="xlstm-first-step-"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    out = {"arch": ARCH, "card": smi.stdout.strip()}
    st, metrics = {}, {}
    t, params, opt = _trainer(c, torch, None, dev, tmp)
    p0 = {k: p.detach().clone() for k, p in params.items()}
    b1 = t.opt_cfg.b1
    st["S"], metrics["S"] = _first(c, torch, t, params, opt)
    runs = [("S_again", 0.0, 0)] + [(f"P{i + 1}", CONTROL_EPS, s)
                                    for i, s in enumerate(CONTROL_SEEDS)]
    for tag, eps, seed in runs:
        t, params, opt = _trainer(c, torch, None, dev, tmp, eps, seed)
        st[tag], metrics[tag] = _first(c, torch, t, params, opt)
        del t, params, opt
        torch.cuda.empty_cache()
    again = st.pop("S_again")
    out["single_bits_repeat"] = metrics["S_again"] == metrics["S"] and all(
        torch.equal(again[k][0], st["S"][k][0]) for k in again)
    del again
    res = launcher.run_local(2, __file__, args=["--rank", str(tmp)],
                             timeout_s=900, grace_s=10)
    if not res.ok:
        print(res.summary(4000))
        return 1
    metrics["T"] = json.loads((tmp / "world.json").read_text())
    out["metrics"] = metrics
    S = st["S"]
    st["T"] = {k: tuple(torch.from_numpy(np.load(tmp / f"T.{k}.{s}.npy"))
                        .to(dev) for s in ("p", "m")) for k in S}
    near, leaves = {}, {}
    for k, (p, m) in S.items():
        g = m.abs() / (1 - b1)
        near[k] = ~((g > c.STEP_GRAD_TOL * g.max().clamp_min(1e-30))
                    & (g > c.STEP_FLOOR))
        row = {"entries": p.numel(), "near_sign": int(near[k].sum())}
        for tag in ("T", "P1", "P2"):
            po, mo = st[tag][k]
            row[f"{tag}_grad_rel"] = float((mo - m).abs().max()
                                           / m.abs().max())
            kept = ~near[k]
            row[f"{tag}_param_max_abs"] = float(
                (po - p).abs()[kept].max()) if kept.any() else 0.0
            row[f"{tag}_sign_flips"] = int((torch.sign(mo)
                                            != torch.sign(m)).sum())
        leaves[k] = row
    out["leaves"] = leaves
    out["summary"] = {f"{tag}_{f}": (sum if f == "sign_flips" else max)(
        r[f"{tag}_{f}"] for r in leaves.values())
        for tag in ("T", "P1", "P2")
        for f in ("grad_rel", "param_max_abs", "sign_flips")}
    out["summary"]["near_sign"] = sum(r["near_sign"] for r in leaves.values())
    out["summary"]["entries"] = sum(r["entries"] for r in leaves.values())

    # the second step at mixed states, on one model
    t, params, _ = _trainer(c, torch, None, dev, tmp)
    batch = c.train_dist_family_batch(torch, t.cfg, 1, t.device)
    logs = []
    chunkwise = xlstm._mlstm_chunkwise

    def spy(q, k, v, i_pre, f_pre, state, chunk):
        with torch.no_grad():
            logs.append(normalizer_ties(torch, xlstm, q, k, i_pre, f_pre,
                                        state, chunk))
        return chunkwise(q, k, v, i_pre, f_pre, state, chunk)

    T, P1 = st["T"], st["P1"]
    picks = {
        "S": lambda k: S[k][0], "T": lambda k: T[k][0],
        "P1": lambda k: P1[k][0],
        "S_with_T_near": lambda k: torch.where(near[k], T[k][0], S[k][0]),
        "T_with_S_near": lambda k: torch.where(near[k], S[k][0], T[k][0]),
        "S_near_held": lambda k: torch.where(near[k], p0[k], S[k][0]),
        "T_near_held": lambda k: torch.where(near[k], p0[k], T[k][0])}
    points = {}
    xlstm._mlstm_chunkwise = spy
    try:
        for name, pick in picks.items():
            logs.clear()
            with torch.no_grad():
                for k in params:
                    params[k].copy_(pick(k))
            loss, grads = lm.loss_and_grads(t.model, params, batch)
            gnorm = float(torch.sqrt(sum(g.norm() ** 2
                                         for g in grads.values())))
            fwd = logs[:len(logs) // 2]     # remat's recompute follows
            points[name] = {
                "loss": float(loss), "grad_norm": gnorm,
                "tie_margin": [float(x.abs().min()) for x in fwd],
                "floored": [int((x < 0).sum()) for x in fwd],
                "normalizers": int(fwd[0].numel())}
    finally:
        xlstm._mlstm_chunkwise = chunkwise
    out["second_step"] = points
    shutil.rmtree(tmp, ignore_errors=True)
    pathlib.Path(a.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: out[k] for k in ("card", "single_bits_repeat",
                                          "metrics", "summary",
                                          "second_step")}))
    return 0


if __name__ == "__main__":
    if "--rank" in sys.argv:
        rank_main(pathlib.Path(sys.argv[sys.argv.index("--rank") + 1]))
    else:
        sys.exit(main())
