"""The port's multi-rank tools on the CPU over gloo
(``vince_tpu_torch/tools/{soak_multichip,audit_collectives,dryrun_multichip}.py``,
the counterparts of ``tools/soak_multichip.py``, ``tools/audit_collectives.py``
and ``__graft_entry__.py``'s ``dryrun_multichip``), run side by side:

- the soak, 5 steps of the production step (ResNet18, 32², queue 64,
  embeddings 16, shuffled BN and sync-BN) on the 1x1, 2x1 and 1x2 meshes:
  ``PARITY OK``, exit 0;
- the audit of one step on 2x1 and 1x2 in both shuffle modes (ResNet18, 8
  rows a data index at 32², queue 256, bf16): the collectives' kinds,
  axes, counts and bytes are the analytic table's, and no collective moves
  the queue bank; a payload shaped as the bank, or a collective from a site
  the step does not have, fails it;
- ``dryrun_multichip(4)`` on a 2x2 mesh: its ``OK`` line."""

import concurrent.futures
import dataclasses
import json

import pytest

from torch_port_ranks import audit_jobs_rank, spawn
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)
from vince_tpu_torch.tools import audit_collectives, dryrun_multichip, soak_multichip

MESHES = [(2, 1), (1, 2)]
MODES = ("gather", "a2a")
AUDIT = audit_collectives.audit_options(True, image=32, queue=256)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("soak") / "soak.json"
    jobs = [(md, mq, dataclasses.replace(AUDIT, shuffle_mode=mode))
            for md, mq in MESHES for mode in MODES]
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        soak = pool.submit(soak_multichip.main, [
            "--platform", "cpu", "--steps", "5", "--image", "32", "--queue", "64",
            "--batch", "16", "--embed", "16", "--meshes", "1x1,2x1,1x2", "--json", str(out)])
        audits = pool.submit(spawn, audit_jobs_rank, 2, jobs)
        dryrun = pool.submit(dryrun_multichip.dryrun_multichip, 4, platform="cpu")
        return dict(soak=(soak.result(), json.loads(out.read_text())),
                    audits=dict(zip([(md, mq, opts.shuffle_mode) for md, mq, opts in jobs],
                                    audits.result()[0])),
                    dryrun=dryrun.result())


def test_soak_parity_across_meshes(runs):
    code, summary = runs["soak"]
    assert code == 0 and summary["parity_ok"]
    results = summary["results"]
    assert [r["mesh"] for r in results] == ["1x1", "2x1", "1x2"]
    for r in results:
        assert len(r["losses"]) == 5
        assert (r["queue_tail"], r["queue_total"]) == (5 * 16 % 64, 64)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("md,mq", MESHES)
def test_audit_matches_the_analytic_table(runs, md, mq, mode):
    r = runs["audits"][md, mq, mode]
    assert r["problems"] == [], "\n".join(audit_collectives.summary(r))
    by_role = {}
    for c in r["collectives"]:
        by_role.setdefault(c["role"], []).append(c)
    (images,) = by_role["key images"]
    rows = AUDIT.batch
    assert images["op"] == ("all_to_all" if mode == "a2a" else "all_gather")
    # the a2a moves the local batch, 1/d of the gather's result
    assert images["shape"] == ([rows, 32, 32, 3] if mode == "a2a" else [md * rows, 32, 32, 3])
    assert images["dtype"] == "c10::BFloat16"
    (keys,) = by_role["key embeddings"]
    assert keys["shape"] == [md * rows, AUDIT.embed] and keys["dtype"] == "float"
    assert sorted(r["table"]) == sorted(by_role)


def test_audit_fails_a_moved_queue_or_an_unknown_site(runs):
    r = runs["audits"][2, 1, "gather"]
    cfg = audit_collectives.audit_config(AUDIT, 2, 1)
    bank = dict(op="all_gather", shape=[cfg.queue_size, cfg.embed_size], dtype="float",
                bytes=cfg.queue_size * cfg.embed_size * 4, prims=["_gather"],
                site=("solvers/vince_step.py", "_key_embeddings"), role="key embeddings",
                axis="data")
    problems = audit_collectives.check(r["collectives"] + [bank], r["table"], cfg)
    assert any("queue bank moves" in p for p in problems)
    assert any("key embeddings: 2 collectives" in p for p in problems)
    stray = dict(bank, shape=[4], bytes=16, site=("ops/queue.py", "enqueue"), role=None)
    problems = audit_collectives.check(r["collectives"] + [stray], r["table"], cfg)
    assert any("should not make" in p for p in problems)


def test_dryrun_multichip_4(runs):
    line = runs["dryrun"]
    assert line.startswith("dryrun_multichip(4): mesh=(2x2) total_loss=") and line.endswith(" OK")
