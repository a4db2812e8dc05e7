"""12-slot rung-separation screen.

The r4 Tmall 5-seed ladder showed the dual-side rungs tied-within-1sd on
the 12-slot layout (crossattr knobs were tuned on 9-slot Taobao); the one
knob probed (drift_active=2.0) was retired. This is the prescribed cheap
2-arm screen: configs0 vs configs3 ONLY, 3 train seeds, over a small
(persist, sig_frac, junk_frac, events) grid at 12 slots, looking for a
regime where the configs3-over-configs0 margin is seed-robust. A winning
combo then gets the full 4-rung 3-seed ladder (scripts/ladder.py); a dry
grid pins the impossibility row instead.

Knob rationale (BASELINE.md Tmall scoping row): 12-slot failure mode is
(a) attr drift accumulating over more slots -> persist up; (b) sparser
per-slot neighbor sets at the fixed 400k-event budget -> events scaled by
12/9; (c) relational signal share -> sig_frac up / junk_frac down.

Usage: python scripts/screen12.py [out_json] [combo indices, e.g. 0 2 4]
"""

import json
import sys
import time

sys.path.insert(0, ".")

import jax

jax.config.update("jax_platforms", "cpu")  # CPU-forced (CLAUDE.md gotcha)

from score_tpu.config import PRESETS  # noqa: E402
from score_tpu.train import train  # noqa: E402

BASE = dict(num_users=3000, num_items=6000, num_events=400_000,
            mode="crossattr", drift_active=3.0, sig_frac=0.7, junk_frac=0.2)
GRID = [
    dict(persist=0.9),
    dict(persist=0.9, sig_frac=0.8, junk_frac=0.1),
    dict(sig_frac=0.85, junk_frac=0.05),
    dict(num_events=533_333),                      # 12/9 x: equal per-slot density
    dict(persist=0.9, num_events=533_333),
]
SEEDS = (0, 1, 2)
EPOCHS = 4


def run_combo(idx, knobs):
    import hashlib

    from score_tpu.data.prep_datasets import PREP

    gen_kw = dict(BASE, **knobs)
    canon = {k: (float(v) if isinstance(v, (int, float)) else v)
             for k, v in gen_kw.items()}
    gh = hashlib.md5(json.dumps(canon, sort_keys=True).encode()) \
        .hexdigest()[:6]
    tag = f"tmall_crossattr_{gh}"
    ds = PREP["tmall"](f"/tmp/score_tpu_data/ladder_{tag}",
                       raw_path=f"/tmp/score_tpu_raw/ladder_{tag}.csv",
                       synth_kw=gen_kw)
    row = dict(knobs=knobs, seeds={})
    for seed in SEEDS:
        aucs = {}
        for name in ("configs0", "configs3"):
            cfg = PRESETS[name]()
            cfg = cfg.replace(train=cfg.train.__class__(
                batch_size=512, learning_rate=1e-3, num_epochs=EPOCHS,
                eval_every_steps=300, early_stop_patience=6,
                log_every_steps=10 ** 9, seed=seed))
            t0 = time.time()
            out = train(cfg, ds, verbose=False)
            aucs[name] = out["best_val_auc"]
            print(json.dumps(dict(combo=idx, seed=seed, model=name,
                                  val_auc=round(out["best_val_auc"], 4),
                                  wall_s=round(time.time() - t0, 1))),
                  flush=True)
        margin = aucs["configs3"] - aucs["configs0"]
        row["seeds"][seed] = dict(configs0=aucs["configs0"],
                                  configs3=aucs["configs3"],
                                  margin=round(margin, 4))
    ms = [float(row["seeds"][s]["margin"]) for s in SEEDS]
    row["margin_mean"] = round(sum(ms) / len(ms), 4)
    row["margin_min"] = round(min(ms), 4)
    row["seed_robust"] = bool(min(ms) > 0.005)  # np.bool_ is not JSON
    print(json.dumps(dict(combo=idx, **{k: row[k] for k in
                                        ("knobs", "margin_mean", "margin_min",
                                         "seed_robust")})), flush=True)
    return row


def main():
    args = sys.argv[1:]
    out_path = "/tmp/screen12.json"
    if args and not args[0].isdigit():
        out_path, args = args[0], args[1:]
    idxs = [int(a) for a in args] or list(range(len(GRID)))
    results = {}
    for i in idxs:
        results[str(i)] = run_combo(i, GRID[i])
        with open(out_path, "w") as f:
            json.dump(results, f, indent=2)
    print(f"wrote {out_path}", flush=True)


if __name__ == "__main__":
    main()
