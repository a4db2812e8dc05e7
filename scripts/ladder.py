"""Run the config ladder (configs0..3) on one dataset and
report per-rung metrics — the ablation-monotonicity oracle of SURVEY.md §4.1:
each rung should improve validation AUC over the previous.

With --baselines, also runs the reference's baseline-model roster
(SURVEY.md §2.3 #14: pop/MF/SVD++/GRU4Rec/Caser/SASRec/RRN/DELF-style) under
the identical train/eval protocol — the paper-§4.3-style comparison table
where full SCoRe (configs3) should lead.

Usage: python scripts/ladder.py [out_json] [dataset] [epochs] [--baselines]
           [mode=collab|crossattr|latent] [seed=N] [models=a,b,...]
           [gen knob k=v ...]

seed= sets the TRAIN seed only (the dataset is the same pinned prep for all
seeds — the multi-seed protocol of BASELINE.md). models= restricts the
roster to a comma list of preset names.

mode=crossattr uses the cross-side relational generator
with the skew defaults that make the co-attention rung's advantage
measurable (drift_active=3, sig_frac=0.7, junk_frac=0.2 — see BASELINE.md).
"""

import json
import sys
import time

sys.path.insert(0, ".")

from score_tpu.config import BASELINE_PRESETS, PRESETS
from score_tpu.train import train


def main():
    kv = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
    args = [a for a in sys.argv[1:] if a != "--baselines" and "=" not in a]
    with_baselines = "--baselines" in sys.argv[1:]
    from score_tpu.data.prep_datasets import PREP
    out_path = args[0] if len(args) > 0 else "/tmp/ladder.json"
    dataset = args[1] if len(args) > 1 else "taobao"
    epochs = int(args[2]) if len(args) > 2 else 3
    mode = kv.pop("mode", "collab")
    seed = int(kv.pop("seed", "0"))
    models = kv.pop("models", None)
    gen_kw = dict(num_users=3000, num_items=6000, num_events=400_000,
                  mode=mode)
    if mode == "crossattr":
        gen_kw.update(drift_active=3.0, sig_frac=0.7, junk_frac=0.2)
    gen_kw.update({k: float(v) if "." in v else int(v)
                   for k, v in kv.items()})

    # the raw-CSV cache must key on the generator knobs, or a re-run with
    # different num_users/num_events silently reuses the stale file
    # (prep_datasets._load_or_synth skips synthesis when the path exists)
    import hashlib
    # canonicalize numerics (3 vs 3.0 must hash identically)
    canon = {k: (float(v) if isinstance(v, (int, float)) else v)
             for k, v in gen_kw.items()}
    gh = hashlib.md5(json.dumps(canon, sort_keys=True).encode()) \
        .hexdigest()[:6]
    tag = (dataset if mode == "collab" else f"{dataset}_{mode}") + f"_{gh}"
    ds = PREP[dataset](f"/tmp/score_tpu_data/ladder_{tag}",
                       raw_path=f"/tmp/score_tpu_raw/ladder_{tag}.csv",
                       synth_kw=gen_kw)
    print(f"{dataset}: users={ds.num_users} items={ds.num_items} "
          f"train={len(ds.train)}", flush=True)

    results = {}
    if models:
        names = models.split(",")
    else:
        names = list(BASELINE_PRESETS) if with_baselines else []
        names += ["configs0", "configs1", "configs2", "configs3"]
    for name in names:
        cfg = PRESETS[name]()
        cfg = cfg.replace(train=cfg.train.__class__(
            batch_size=512, learning_rate=1e-3, num_epochs=epochs,
            eval_every_steps=300, early_stop_patience=6,
            log_every_steps=10 ** 9, seed=seed))
        t0 = time.time()
        out = train(cfg, ds, verbose=False)
        results[name] = dict(
            best_val_auc=out["best_val_auc"],
            test=out["test"], steps=out["steps_run"],
            wall_s=round(time.time() - t0, 1))
        print(f"{name}: val_auc={out['best_val_auc']:.4f} "
              f"test_auc={out['test']['auc']:.4f} "
              f"ndcg@10={out['test']['ndcg@10']:.4f} "
              f"wall={results[name]['wall_s']}s", flush=True)

    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    rungs = [n for n in ("configs0", "configs1", "configs2", "configs3")
             if n in results]
    if len(rungs) == 4:
        aucs = [results[n]["best_val_auc"] for n in rungs]
        print("ladder val AUCs:", [round(a, 4) for a in aucs], flush=True)
        print("monotone:",
              all(b >= a - 0.002 for a, b in zip(aucs, aucs[1:])),
              flush=True)


if __name__ == "__main__":
    main()
