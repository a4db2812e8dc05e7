"""Fast CPU mini-ladder for iterating on synthetic-generator design
(configs3 must strictly beat configs2).

Runs selected configs on a small synth dataset, CPU-forced so the
accelerator is never touched. Usage:

  python scripts/ladder_mini.py [mode=crossattr] [users=800] [items=6000] \
      [events=120000] [epochs=6] [configs=0,1,2,3] [seed=0] [out=/tmp/...json]
      [key=value model/train overrides, e.g. model.embed_dim=32]
"""

import json
import sys
import time

sys.path.insert(0, ".")

import jax

jax.config.update("jax_platforms", "cpu")  # noqa: E402 (CLAUDE.md gotcha)

from score_tpu.config import PRESETS, apply_overrides  # noqa: E402
from score_tpu.data.prep_datasets import prep_taobao  # noqa: E402
from score_tpu.train import train  # noqa: E402


def main():
    kw = dict(mode="crossattr", users=800, items=6000, events=120_000,
              epochs=6, configs="0,1,2,3", seed=0, out="/tmp/ladder_mini.json")
    gen_kw = dict(sig_frac=0.5, junk_frac=0.3, stable_frac=0.5, persist=0.75,
                  num_communities=16, drift_active=1.0)
    overrides = {}
    for a in sys.argv[1:]:
        k, v = a.split("=", 1)
        if k in kw:
            kw[k] = type(kw[k])(v)
        elif k in gen_kw:
            gen_kw[k] = type(gen_kw[k])(v)
        else:
            overrides[k] = v

    tag = (f"{kw['mode']}_{kw['users']}_{kw['items']}_{kw['events']}"
           f"_{kw['seed']}_" + "_".join(str(v) for v in gen_kw.values()))
    ds = prep_taobao(
        f"/tmp/score_tpu_data/mini_{tag}",
        raw_path=f"/tmp/score_tpu_raw/mini_{tag}.csv",
        seed=kw["seed"],
        synth_kw=dict(num_users=kw["users"], num_items=kw["items"],
                      num_events=kw["events"], mode=kw["mode"], **gen_kw))
    print(f"dataset: users={ds.num_users} items={ds.num_items} "
          f"train={len(ds.train)} val={len(ds.val)}", flush=True)

    results = {}
    for idx in kw["configs"].split(","):
        name = f"configs{idx}" if idx.isdigit() else idx
        cfg = PRESETS[name]()
        cfg = cfg.replace(train=cfg.train.__class__(
            batch_size=512, learning_rate=1e-3, num_epochs=kw["epochs"],
            eval_every_steps=300, early_stop_patience=8,
            log_every_steps=10 ** 9, seed=0))
        if overrides:
            cfg = apply_overrides(cfg, overrides)
        t0 = time.time()
        out = train(cfg, ds, verbose=False)
        results[name] = dict(best_val_auc=out["best_val_auc"],
                             test_auc=out["test"]["auc"],
                             ndcg10=out["test"]["ndcg@10"],
                             wall_s=round(time.time() - t0, 1))
        print(f"{name}: val_auc={out['best_val_auc']:.4f} "
              f"test_auc={out['test']['auc']:.4f} "
              f"wall={results[name]['wall_s']}s", flush=True)

    with open(kw["out"], "w") as f:
        json.dump(results, f, indent=2)


if __name__ == "__main__":
    main()
