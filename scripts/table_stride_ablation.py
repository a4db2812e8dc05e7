"""Stride-K table-update quality gate.

TrainConfig.table_update_every=K skips the table-grad scatter-adds and
the table adam update on (K-1)/K of steps —
tables train on a 1/K batch subsample. Contract-change precedent:
inbatch_iw (BASELINE.md r2) was adopted after a 3-seed quality gate; this
script runs the same gate for K ∈ {2, 4} on the pinned crossattr dataset.

The K=1 reference arm is the pinned configs3 3-seed row (val AUC
0.7728±.008, per-seed 0.7766/0.7613/0.7804 — BASELINE.md r3 multi-seed
ladder; identical dataset, knobs, and seeds). Pass `k1` in the strides list
to re-measure it.

Usage: python scripts/table_stride_ablation.py [out_json] [epochs] [K,K,..]
"""

import json
import sys
import time

sys.path.insert(0, ".")

import dataclasses

from score_tpu.config import PRESETS

GEN_KW = dict(num_users=3000, num_items=6000, num_events=400_000,
              mode="crossattr", drift_active=3.0, sig_frac=0.7, junk_frac=0.2)
SEEDS = (0, 1, 2)
PINNED_K1 = {"val_auc": [0.7766, 0.7613, 0.7804],
             "source": "BASELINE.md r3 multi-seed ladder (same dataset/knobs)"}


def main():
    from score_tpu.data.prep_datasets import PREP
    from score_tpu.train import train
    out_path = sys.argv[1] if len(sys.argv) > 1 else "/tmp/table_stride.json"
    epochs = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    # arm spec: "2,4" = strides 2 and 4; "2b2" = stride 2 with
    # table_lr_boost 2 (the K-fold-fewer-steps compensation)
    raw = sys.argv[3].split(",") if len(sys.argv) > 3 else ["2", "4"]
    arms = []
    for a in raw:
        K, _, b = a.partition("b")
        arms.append((int(K), float(b) if b else 1.0))

    ds = PREP["taobao"]("/tmp/score_tpu_data/ladder_taobao_crossattr",
                        raw_path="/tmp/score_tpu_raw/ladder_taobao_crossattr.csv",
                        synth_kw=GEN_KW)
    print(f"dataset: users={ds.num_users} items={ds.num_items} "
          f"train={len(ds.train)}", flush=True)

    results = {"pinned_k1": PINNED_K1}
    for K, boost in arms:
        arm = f"stride{K}" + (f"_boost{boost:g}" if boost != 1.0 else "")
        results[arm] = []
        for seed in SEEDS:
            cfg = PRESETS["configs3"]()
            cfg = cfg.replace(train=dataclasses.replace(
                cfg.train, batch_size=512, learning_rate=1e-3,
                num_epochs=epochs, eval_every_steps=300,
                early_stop_patience=6, log_every_steps=10 ** 9, seed=seed,
                table_update_every=K, table_lr_boost=boost))
            t0 = time.time()
            out = train(cfg, ds, verbose=False)
            rec = dict(seed=seed, K=K, boost=boost,
                       best_val_auc=out["best_val_auc"],
                       test_auc=out["test"]["auc"],
                       ndcg10=out["test"]["ndcg@10"],
                       wall_s=round(time.time() - t0, 1))
            results[arm].append(rec)
            print(f"{arm} seed={seed}: val_auc={rec['best_val_auc']:.4f} "
                  f"test_auc={rec['test_auc']:.4f} "
                  f"ndcg@10={rec['ndcg10']:.4f} wall={rec['wall_s']}s",
                  flush=True)

    import numpy as np
    ref = np.array(PINNED_K1["val_auc"])
    print(f"pinned K=1: val_auc mean={ref.mean():.4f} sd={ref.std():.4f}",
          flush=True)
    for arm, recs in results.items():
        if arm == "pinned_k1":
            continue
        v = np.array([r["best_val_auc"] for r in recs])
        print(f"{arm}: val_auc mean={v.mean():.4f} sd={v.std():.4f} "
              f"delta_vs_k1={v.mean() - ref.mean():+.4f}", flush=True)
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)


if __name__ == "__main__":
    main()
