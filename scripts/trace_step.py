"""Device-time breakdown of the bench train step from one jax.profiler trace.

Builds bench.py's configuration (same synthetic data, model and training
knobs), warms the fused 50-step loop up, traces two more chunks, and
reduces the trace to:

  * the device busy time per step (union of kernel intervals on the card);
  * the device time of the ops under the named scopes `coattn` (the
    co-attention block) and `table_gather` (the embedding-table gathers),
    forward and backward, each op in one exclusive bucket, attributed through the compiled HLO's op_name
    metadata: an op counts toward a scope when its own op_name, or that of
    any instruction fused into it, lies under the scope;
  * the top ops by device time.

Writes <out_dir>/trace_step.json (and the trace itself under <out_dir>).
Needs a GPU. Usage: python scripts/trace_step.py [out_dir]

XLA launches most of a step as CUDA graphs ("command buffers"), which the
trace shows as one event each; the per-scope split needs them off:
    XLA_FLAGS=--xla_gpu_enable_command_buffer= python scripts/trace_step.py
The busy and idle shares are read with them on, as the program runs.
"""

from __future__ import annotations

import collections
import glob
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

SCOPES = ("coattn", "table_gather")


def hlo_scopes(hlo_text: str) -> dict:
    """instruction name -> set of SCOPES its work falls under (own op_name
    plus the op_names of a fusion's fused computation)."""
    comp_scopes = collections.defaultdict(set)
    own = {}
    calls = {}
    comp = None
    for line in hlo_text.splitlines():
        m = re.match(r"\s*(?:ENTRY\s+)?%?([\w.\-]+)\s+\(.*\)\s*->.*\{\s*$",
                     line)
        if m:
            comp = m.group(1)
            continue
        m = re.match(r"\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=", line)
        if not m:
            continue
        name = m.group(1)
        op = re.search(r'op_name="([^"]*)"', line)
        # forward ops sit under ".../coattn/...", backward ones under
        # ".../transpose(jvp(coattn))/..."; each tag also gets a .fwd or
        # .bwd twin
        tags = {s for s in SCOPES if op and re.search(
            rf"(^|[/(]){s}([/)]|$)", op.group(1))}
        if tags:
            half = ".bwd" if "transpose(" in op.group(1) else ".fwd"
            tags |= {t + half for t in tags}
        own[name] = tags
        if comp is not None:
            comp_scopes[comp] |= tags
        c = re.search(r"calls=%?([\w.\-]+)", line)
        if c:
            calls[name] = c.group(1)
    return {n: own[n] | comp_scopes.get(calls.get(n), set()) for n in own}


def category(tags: set) -> str:
    """One exclusive bucket per op, e.g. 'coattn fwd', 'coattn bwd+fwd'
    (a fusion holding both passes), 'coattn+table_gather bwd' (a fusion
    holding work of both scopes), or 'unscoped'."""
    base = sorted(t for t in tags if "." not in t)
    if not base:
        return "unscoped"
    halves = sorted({t.split(".")[1] for t in tags if "." in t})
    return "+".join(base) + " " + "+".join(halves)


def reduce_trace(xplane_path: str, scopes_of: dict, steps: int) -> dict:
    import jax
    pd = jax.profiler.ProfileData.from_file(xplane_path)
    per_op = collections.Counter()
    per_line = collections.Counter()
    intervals = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        # kernels sit on the per-stream lines; derived summary lines (XLA
        # Ops, XLA Modules, ...) repeat them and would count them twice
        streams = [ln for ln in lines if ln.name.startswith("Stream")]
        for line in streams or lines:
            for ev in line.events:
                stats = dict(ev.stats)
                if "hlo_op" not in stats:       # memcpy, markers, ...
                    continue
                op = stats["hlo_op"]
                per_op[op] += ev.duration_ns
                per_line[f"{plane.name} {line.name}"] += ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    intervals.sort()
    busy, end = 0.0, -1.0
    for s, e in intervals:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = (intervals[-1][1] - intervals[0][0]) if intervals else 0.0
    by_scope = collections.Counter()
    for op, t in per_op.items():
        by_scope[category(scopes_of.get(op, set()))] += t
    total = sum(per_op.values())
    top = [{"op": op, "ms_per_step": t / 1e6 / steps,
            "scope": category(scopes_of.get(op, set()))}
           for op, t in per_op.most_common(25)]
    return {
        "steps": steps,
        "kernel_ms_per_step": total / 1e6 / steps,
        "busy_ms_per_step": busy / 1e6 / steps,
        "window_ms_per_step": window / 1e6 / steps,
        "idle_share": 1.0 - busy / window if window else None,
        "scope_ms_per_step": {s: t / 1e6 / steps
                              for s, t in by_scope.most_common()},
        "scope_share_of_kernel_time": {s: t / total if total else None
                                       for s, t in by_scope.most_common()},
        "unmatched_ops": sum(1 for op in per_op if op not in scopes_of),
        "line_ms_per_step": {k: t / 1e6 / steps
                             for k, t in per_line.items()},
        "top_ops": top,
    }


def main(argv) -> None:
    out_dir = os.path.abspath(argv[0] if argv else "chiprun_out/trace_step")
    os.makedirs(out_dir, exist_ok=True)
    import jax
    import jax.numpy as jnp

    from chip_smoke import Shape, flagship_config, make_dataset
    from score_tpu.data.pipeline import TargetIterator
    from score_tpu.graph import device_graph
    from score_tpu.runtime import (gpu_name_and_power_limit, require_gpu,
                                   setup_compile_cache)
    from score_tpu.train import (_stack_batches, build_model, init_state,
                                 item_importance_weights, make_train_loop)

    dev = require_gpu()
    setup_compile_cache()
    card = gpu_name_and_power_limit()
    print(card, flush=True)
    shape = Shape()
    ds = make_dataset(shape, 0)
    cfg = flagship_config(shape)
    graph = device_graph(ds.graph)
    model = build_model(cfg, ds.num_users, ds.num_items)
    rng = jax.random.PRNGKey(0)
    state = init_state(cfg, model, graph, rng)
    neg_iw = jnp.asarray(item_importance_weights(ds.train, ds.num_items))
    loop = make_train_loop(model, cfg, neg_iw=neg_iw)
    it = TargetIterator(ds.train, shape.batch, seed=0)
    K = shape.chunk
    stacks = [_stack_batches(it, K) for _ in range(3)]
    hlo = loop.lower(state, graph, stacks[0], rng, 0).compile().as_text()
    with open(os.path.join(out_dir, "train_loop.hlo.txt"), "w") as f:
        f.write(hlo)
    state, ms = loop(state, graph, stacks[0], rng, 0)
    float(ms["loss"][-1])                                 # warm up
    with jax.profiler.trace(out_dir):
        for s in stacks[1:]:
            state, ms = loop(state, graph, s, rng, 0)
        float(ms["loss"][-1])
    path = sorted(glob.glob(os.path.join(out_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    res = reduce_trace(path, hlo_scopes(hlo), 2 * K)
    res.update(card=card, device_kind=dev.device_kind,
               xla_flags=os.environ.get("XLA_FLAGS", ""),
               config="bench: configs3 embed 32 hidden 64 mlp (128,64) "
                      "bf16 inbatch_iw stride 2 boost 2 batch 4096")
    with open(os.path.join(out_dir, "trace_step.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items()
                      if k != "top_ops"}), flush=True)
    for row in res["top_ops"][:15]:
        print(f"  {row['ms_per_step']:8.4f} ms/step  {row['op'][:48]:48s} "
              f"{row['scope']}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
