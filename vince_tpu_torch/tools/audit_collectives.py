#!/usr/bin/env python
"""Audit of the collectives of the distributed pretraining step (counterpart
of ``tools/audit_collectives.py``).

One eager step of the port's pretraining step on a (data x queue) mesh of
processes runs under ``torch.profiler`` with ``record_shapes``; the tool
reads the step's c10d collectives from the trace (``c10d::allreduce_``,
``c10d::_allgather_base_``, ``c10d::alltoall_base_`` and any other ``c10d::``
op; an all-reduce's payload from the backend's event that follows it,
``gloo:all_reduce`` or ``nccl:all_reduce``) and holds them to what the
algorithm needs and nothing else, JAX's list:

- the key-image move for shuffled BN over ``data``: one all-gather of the
  global key batch (``gather`` mode) or one all-to-all of the local batch
  (``a2a`` mode);
- the key-embedding unshuffle, one all-gather over ``data`` (MoCo's
  ``concat_all_gather``);
- the streamed softmax over ``queue``: per source the pmax of the row
  maxima, the pmax of the raw maxima (a metric), the psum of the exp sums,
  and that psum's backward;
- the gradient reduction over the whole mesh (JAX's pmean over ``data`` and
  psum over ``queue``, one all-reduce here), the running averages of both
  encoders over ``data``, and the metrics over ``data``;
- and no collective whose payload is the queue bank (rows of the queue's
  or its shard's count, of the embedding's width): that would mean the bank
  itself was gathered.

``analytic_table`` gives each collective's count and bytes from the
configuration's shapes alone, in the port's dtypes (the key images move in
the compute dtype, bf16 on the card; the embeddings and the gradients in
f32), so that a widened gather or an accidental reshard fails. The profiler
records no process group, and no Python frame of a c10d op on every torch
(2.11's traces have none), so while the step runs the tool hooks the calls
of ``parallel/collectives.py`` into ``torch.distributed`` and records each
call's frames in order (``call_sites``), paired with the trace's ops one by
one (their kinds must agree): the axis of a collective is that of its call
site (the innermost frame of the port outside ``parallel/collectives.py``),
a collective from a site the tool does not know fails the audit, and a
psum's backward belongs to the forward psum of its payload's shape.

A captured step's NCCL calls do not show at a CUDA graph's replay, so the
audit reads the eager step (``make_train_step_fn``), the same body.

    python vince_tpu_torch/tools/audit_collectives.py --platform cpu --quick \\
        --meshes 2x1,1x2 --shuffle-mode a2a
    python vince_tpu_torch/tools/audit_collectives.py --meshes 1x1   # one GPU

Prints each mesh's collectives by site and the table's expectations, then
``AUDIT OK`` or ``AUDIT FAILED`` and exits 0 or 1.
"""

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import re
import sys
import traceback
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from vince_tpu_torch.tools.soak_multichip import (  # noqa: E402
    LR, SEED, SoakOptions, global_batch, parse_mesh, soak_config)

# the profiler's names of dtypes, and their bytes
_DTYPE_BYTES = {"float": 4, "double": 8, "c10::BFloat16": 2, "c10::Half": 2, "int": 4,
                "long int": 8, "unsigned char": 1, "signed char": 1, "bool": 1, "short int": 2}
# the c10d dispatcher ops of torch.distributed's calls, by kind
_KINDS = {"c10d::allreduce_": "all_reduce", "c10d::_allgather_base_": "all_gather",
          "c10d::allgather_": "all_gather", "c10d::alltoall_base_": "all_to_all"}
_FRAME = re.compile(r"vince_tpu_torch/([\w/]+\.py)\(\d+\): (\w+)")
_COLLECTIVES_PY = "parallel/collectives.py"

QUICK = dict(backbone="ResNet18", batch=8, image=64, queue=1024)
FULL = dict(backbone="ResNet50", batch=128, image=224, queue=65536)


def audit_options(quick: bool, **overrides) -> SoakOptions:
    """JAX's audit configuration: a video source of 4-frame clips, b rows a
    rank, embeddings 128, bf16, shuffled BN (``--quick``: ResNet18, b = 8 at
    64², q = 1024; else ResNet50, b = 128 at 224², q = 65536)."""
    base = dict(QUICK if quick else FULL, num_frames=4, embed=128, compute_dtype="bfloat16",
                steps=1)
    base.update(overrides)
    return SoakOptions(**base)


def audit_config(opts: SoakOptions, md: int, mq: int):
    """The soak's step as JAX's audit compiles it: shuffled BN, no sync-BN,
    ``opts.batch`` rows on each data index."""
    return dataclasses.replace(
        soak_config(dataclasses.replace(opts, batch=opts.batch * md), md, mq), sync_bn=False)


def _nbytes(shape, dtype: str) -> int:
    n = 1
    for d in shape:
        n *= d
    if dtype not in _DTYPE_BYTES:
        raise ValueError(f"no size known for the profiler's dtype {dtype!r}")
    return n * _DTYPE_BYTES[dtype]


def _port_frames():
    """The port's frames of the calling thread's stack, innermost first, as
    (file under ``vince_tpu_torch/``, function)."""
    out = []
    for frame in reversed(traceback.extract_stack()[:-2]):  # less this hook's own frames
        m = _FRAME.search(f"{frame.filename}({frame.lineno}): {frame.name}")
        if m:
            out.append((m.group(1), m.group(2)))
    return out


@contextlib.contextmanager
def call_sites(record: List):
    """While active, each collective that ``parallel/collectives.py`` calls
    (``dist.all_reduce``, ``dist.all_to_all_single``, its all-gather) appends
    its kind and the caller's port frames to ``record``, in call order."""
    from vince_tpu_torch.parallel import collectives

    targets = [(dist, "all_reduce", "all_reduce"), (dist, "all_to_all_single", "all_to_all"),
               (collectives, "_all_gather_single", "all_gather")]
    originals = [getattr(module, name) for module, name, _ in targets]

    def hook(fn, kind):
        def call(*args, **kwargs):
            record.append((kind, _port_frames()))
            return fn(*args, **kwargs)
        return call

    for (module, name, kind), fn in zip(targets, originals):
        setattr(module, name, hook(fn, kind))
    try:
        yield record
    finally:
        for (module, name, _), fn in zip(targets, originals):
            setattr(module, name, fn)


def _input_dtypes(prof):
    """An event's input dtypes: ``FunctionEvent.input_dtypes`` where torch
    has it, else the profiler's own event of the same id and name (torch 2.11's
    ``FunctionEvent`` keeps the shapes only)."""
    by_id = {k.correlation_id(): k for k in prof.profiler.kineto_results.events()}

    def dtypes(event):
        if hasattr(event, "input_dtypes"):
            return event.input_dtypes
        k = by_id.get(event.id)
        if k is None or k.name() != event.name:
            raise RuntimeError(f"no profiler event with the dtypes of {event.name}")
        return k.dtypes()

    return dtypes


def collectives_of(prof, sites: List) -> List[Dict]:
    """The trace's c10d collectives in order: kind, payload shape and dtype,
    bytes (an all-gather's result, an all-to-all's input, an all-reduce's
    buffer), and from ``sites`` (``call_sites``' record of the same calls, in
    the same order) the primitives of ``parallel/collectives.py`` and the
    call site."""
    events = sorted(prof.events(), key=lambda e: e.time_range.start)
    dtypes = _input_dtypes(prof)
    out = []
    for i, e in enumerate(events):
        if not e.name.startswith("c10d::"):
            continue
        kind = _KINDS.get(e.name, e.name)
        if kind == "all_gather":
            shape, dtype = e.input_shapes[0], dtypes(e)[0]  # the gathered result
        elif kind == "all_to_all":
            shape, dtype = e.input_shapes[1], dtypes(e)[1]
        else:
            # the backend's event after it carries the tensors
            backend = next((b for b in events[i + 1:]
                            if b.name.split(":")[0] in ("gloo", "nccl")), None)
            if backend is None or not backend.input_shapes:
                raise RuntimeError(f"no backend event with the payload of {e.name}")
            shape, dtype = backend.input_shapes[0], dtypes(backend)[0]
        if len(out) >= len(sites) or sites[len(out)][0] != kind:
            raise RuntimeError(f"the trace's collective {len(out)} ({kind}) is not the "
                               f"step's call {sites[len(out)][0] if len(out) < len(sites) else None}")
        frames = sites[len(out)][1]
        prims = [f for file, f in frames if file == _COLLECTIVES_PY]
        site = next(((file, f) for file, f in frames if file != _COLLECTIVES_PY), None)
        out.append(dict(op=kind, shape=list(shape), dtype=dtype, bytes=_nbytes(shape, dtype),
                        prims=prims, site=site))
    if len(out) != len(sites):
        raise RuntimeError(f"{len(sites)} collectives called, {len(out)} in the trace")
    return out


def classify(colls: List[Dict]) -> None:
    """Name each collective's role and axis in place (``role`` None: a site
    the tool does not know)."""
    psum_roles = {}
    train_body = 0
    for c in colls:
        site, prims = c["site"], c["prims"]
        fn = site[1] if site else None
        role = axis = None
        if "backward" in prims and "_all_reduce" in prims:
            role, axis = psum_roles.get(tuple(c["shape"]), (None, None))
            role = role and role + " backward"
        elif fn == "_key_embeddings":
            moved = {"cross_device_shuffle", "cross_device_shuffle_a2a"} & set(prims)
            role, axis = ("key images" if moved else "key embeddings"), "data"
        elif site and site[0] == "ops/sharded_infonce.py":
            role, axis = ("queue softmax " + ("psum" if "psum" in prims else "pmax")), "queue"
        elif fn == "_mean_metrics":
            role, axis = "metrics", "data"
        elif fn == "_train_body" and "flat_all_reduce_" in prims:
            # the step's order: the gradients, then the running averages
            role, axis = (("gradients", "data x queue"), ("running averages", "data"))[
                min(train_body, 1)]
            train_body += 1
        if role and "psum" in prims and "backward" not in prims:
            psum_roles[tuple(c["shape"])] = (role, axis)
        c["role"], c["axis"] = role, axis


def analytic_table(cfg, local_rows: int) -> Dict[str, Dict]:
    """Each collective of one step, from the configuration's shapes alone:
    its kind, axis, count and bytes (``max_bytes``: a bound, for the small
    ones)."""
    from vince_tpu_torch.solvers.vince_step import build_encoder

    encoder = build_encoder(cfg)
    param_bytes = sum(p.numel() * p.element_size() for p in encoder.parameters())
    stat_bytes = sum(t.numel() * t.element_size() for name, t in encoder.named_buffers()
                     if name.endswith(("running_mean", "running_var")))
    img = cfg.image_size
    d = cfg.data_axis_size
    image_item = torch.empty((), dtype=cfg.compute_dtype).element_size()
    n_src = len(cfg.sources)
    return {
        # every rank receives the global key batch [d·b, H, W, 3]
        "key images": (dict(op="all_to_all", axis="data", count=1,
                            bytes=local_rows * img * img * 3 * image_item)
                       if cfg.shuffle_mode == "a2a" else
                       dict(op="all_gather", axis="data", count=1,
                            bytes=d * local_rows * img * img * 3 * image_item)),
        # the keys' embeddings of the global batch [d·b, D] in f32
        "key embeddings": dict(op="all_gather", axis="data", count=n_src,
                               bytes=d * local_rows * cfg.embed_size * 4),
        # two pmax and a psum of [b, 1] per source, and the psum's backward
        "queue softmax pmax": dict(op="all_reduce", axis="queue", count=2 * n_src,
                                   bytes=2 * n_src * local_rows * 4),
        "queue softmax psum": dict(op="all_reduce", axis="queue", count=n_src,
                                   bytes=n_src * local_rows * 4),
        "queue softmax psum backward": dict(op="all_reduce", axis="queue", count=n_src,
                                            bytes=n_src * local_rows * 4),
        # the query encoder's gradients, one flat f32 buffer
        "gradients": dict(op="all_reduce", axis="data x queue", count=1, bytes=param_bytes),
        # the running averages of the query and the key encoders
        "running averages": dict(op="all_reduce", axis="data", count=1, bytes=2 * stat_bytes),
        # the metrics, one small f32 vector
        "metrics": dict(op="all_reduce", axis="data", count=1, max_bytes=4096),
    }


def check(colls: List[Dict], table: Dict[str, Dict], cfg) -> List[str]:
    """What in ``colls`` departs from ``table``: an unknown collective, a
    count, a kind, an axis or bytes other than the table's, the queue bank
    in a payload."""
    problems = []
    for c in colls:
        if c["role"] is None or c["role"] not in table:
            problems.append(f"a collective the step should not make: {c}")
    by_role = collections.defaultdict(list)
    for c in colls:
        by_role[c["role"]].append(c)
    for role, want in table.items():
        got = by_role.get(role, [])
        if len(got) != want["count"]:
            problems.append(f"{role}: {len(got)} collectives, expected {want['count']}")
        for c in got:
            if (c["op"], c["axis"]) != (want["op"], want["axis"]):
                problems.append(f"{role}: {c['op']} over {c['axis']}, expected {want['op']} "
                                f"over {want['axis']}")
        total = sum(c["bytes"] for c in got)
        if "bytes" in want and got and total != want["bytes"]:
            problems.append(f"{role}: {total} bytes, expected {want['bytes']}")
        if "max_bytes" in want and total > want["max_bytes"]:
            problems.append(f"{role}: {total} bytes, more than {want['max_bytes']}")
    rows = {cfg.queue_size, cfg.queue_size // cfg.queue_axis_size}
    for c in colls:
        shape = c["shape"]
        if len(shape) >= 2 and shape[-1] == cfg.embed_size and rows & set(shape[:-1]):
            problems.append(f"the queue bank moves: {c}")
    return problems


def audit_rank(rank: int, world: int, md: int, mq: int, opts: SoakOptions, platform: str,
               device: Optional[torch.device] = None) -> Dict:
    """One warm-up step, then one step under the profiler, on this rank of an
    ``md`` x ``mq`` mesh; the collectives, the table and the problems."""
    from torch.profiler import ProfilerActivity, profile

    from vince_tpu_torch.parallel.mesh import Mesh, MeshSpec
    from vince_tpu_torch.parallel.multihost import local_device, local_slice
    from vince_tpu_torch.solvers.vince_step import (
        build_vince_optimizer, init_vince_state, make_train_step_fn)

    device = device or local_device(platform)
    mesh = Mesh(MeshSpec(md, mq))
    cfg = audit_config(opts, md, mq)
    opt = build_vince_optimizer(LR)
    state = init_vince_state(SEED, cfg, opt, device=device, mesh=mesh)
    step = make_train_step_fn(cfg, opt, mesh=mesh)
    full = dataclasses.replace(opts, batch=opts.batch * md)
    batches = [({k: local_slice(v, mesh.data_index, md)
                 for k, v in global_batch(full, i, device).items()},) for i in range(2)]
    step(state, batches[0], 1)
    # the collectives are host-side ops: the device's activity adds nothing
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof, \
            call_sites([]) as sites:
        _, metrics = step(state, batches[1], 1)
        loss = metrics["loss/total_loss"].item()
    colls = collectives_of(prof, sites)
    classify(colls)
    table = analytic_table(cfg, opts.batch)
    return dict(mesh=f"{md}x{mq}", shuffle_mode=cfg.shuffle_mode, loss=loss, collectives=colls,
                table=table, problems=check(colls, table, cfg))


def summary(result: Dict) -> List[str]:
    """A line per role: kind, axis, count and bytes, beside the table's."""
    lines = [f"=== mesh {result['mesh']} ({result['shuffle_mode']}), loss "
             f"{result['loss']:.5f} ==="]
    by_role = collections.defaultdict(list)
    for c in result["collectives"]:
        by_role[c["role"]].append(c)
    for role, got in sorted(by_role.items(), key=lambda kv: str(kv[0])):
        want = result["table"].get(role, {})
        lines.append(f"  {str(role):30s} {got[0]['op']:10s} axis={str(got[0]['axis']):12s} "
                     f"count={len(got):3d} bytes={sum(c['bytes'] for c in got):12d}   table: "
                     f"count={want.get('count')} bytes={want.get('bytes', want.get('max_bytes'))}")
    lines.extend(f"  !! {p}" for p in result["problems"])
    return lines


def run(meshes, opts: SoakOptions, platform: str) -> List[Dict]:
    """Each mesh's rank-0 audit, in new processes (``gloo`` on the CPU, NCCL
    on the GPUs)."""
    from vince_tpu_torch.parallel.launch import run_ranks

    cpu = platform == "cpu"
    return [run_ranks(audit_rank, md * mq, md, mq, opts, platform,
                      backend="gloo" if cpu else "nccl", threads=int(cpu))[0]
            for md, mq in meshes]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="ResNet18, b=8 a rank at 64², q=1024 (else ResNet50, b=128 at 224², "
                         "q=65536)")
    ap.add_argument("--meshes", default="2x1,1x2")
    ap.add_argument("--shuffle-mode", default="gather", choices=["gather", "a2a"])
    ap.add_argument("--use-fused-infonce", action="store_true")
    ap.add_argument("--fold-kernel", action="store_true")
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    opts = audit_options(args.quick, shuffle_mode=args.shuffle_mode,
                         use_fused_infonce=args.use_fused_infonce, fold_kernel=args.fold_kernel)
    results = run([parse_mesh(m) for m in args.meshes.split(",")], opts, args.platform)
    for r in results:
        print("\n".join(summary(r)))
    ok = not any(r["problems"] for r in results)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1, default=str)
        print(f"wrote {args.json}")
    print(f"AUDIT {'OK' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
