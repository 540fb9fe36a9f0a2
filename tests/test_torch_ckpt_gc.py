"""The port's manifest-driven checkpoint GC (`train/checkpoint.py
gc_checkpoints` and `tools/ckpt_gc.py`) on the CPU, against the JAX
package's.

Parity, EXACT: one tree of checkpoints (live, prev, staged, unreferenced,
`.prev-*` and `.tmp-*` siblings, a manifest-less and a corrupt one) is
written, copied, and GC'd by each package's `gc_checkpoints` under the
same references, keep_latest, dry run and refresh script: the retired,
kept and unidentified sets and `bytes_freed` are equal, and what is left
on disk is the same. Both CLIs print the same JSON report for the same
flags (with `--keep`, and scraping one canned federation `/metrics` on a
localhost endpoint), and exit 2 when they cannot reach the metrics. Then
the cases of tests/test_ckpt_gc.py, mirrored.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from dsin_tpu.train import checkpoint as jax_ckpt
from dsin_tpu_torch.train.checkpoint import gc_checkpoints
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fake_ckpt(root, name, digest, step=0, manifest=True):
    """A checkpoint dir as GC sees one: manifest (identity) + meta
    (completeness) + a payload byte. GC never parses the msgpacks, so
    fabricated dirs keep the suite model-free and fast."""
    d = root / name
    d.mkdir()
    (d / "payload.msgpack").write_bytes(b"x" * 64)
    if manifest:
        (d / "manifest.json").write_text(json.dumps(
            {"manifest_version": 1, "step": step,
             "params_digest": digest}))
    (d / "meta.json").write_text(json.dumps({"step": step}))
    return d


def test_gc_retires_only_unreferenced_digests(tmp_path):
    _fake_ckpt(tmp_path, "ckpt_live", "dlive", step=3)
    _fake_ckpt(tmp_path, "ckpt_prev", "dprev", step=2)
    _fake_ckpt(tmp_path, "ckpt_staged", "dstaged", step=1)
    _fake_ckpt(tmp_path, "ckpt_old", "dold", step=0)
    report = gc_checkpoints(
        str(tmp_path), {"dlive", "dprev", "dstaged"}, keep_latest=0)
    assert [r["dir"] for r in report["retired"]] == ["ckpt_old"]
    assert report["bytes_freed"] > 0
    assert not (tmp_path / "ckpt_old").exists()
    # every referenced slot class survived — live, staged, AND prev
    survivors = {k["dir"] for k in report["kept"]}
    assert survivors == {"ckpt_live", "ckpt_prev", "ckpt_staged"}
    for name in survivors:
        assert (tmp_path / name).exists()


def test_gc_never_deletes_an_unmanifested_dir(tmp_path):
    _fake_ckpt(tmp_path, "legacy", "ignored", manifest=False)
    corrupt = _fake_ckpt(tmp_path, "rotted", "dr")
    (corrupt / "manifest.json").write_text("{not json")
    report = gc_checkpoints(str(tmp_path), set(), keep_latest=0)
    assert report["retired"] == []
    assert sorted(report["unidentified"]) == ["legacy", "rotted"]
    assert (tmp_path / "legacy").exists()
    assert (tmp_path / "rotted").exists()


def test_gc_keep_latest_survives_unreferenced(tmp_path):
    for i in range(4):
        _fake_ckpt(tmp_path, f"ckpt_{i}", f"d{i}", step=i)
    report = gc_checkpoints(str(tmp_path), set(), keep_latest=2)
    # newest two (by step) kept; the two oldest retired
    assert {k["dir"] for k in report["kept"]} == {"ckpt_3", "ckpt_2"}
    assert {r["dir"] for r in report["retired"]} == {"ckpt_0", "ckpt_1"}


def test_gc_dry_run_deletes_nothing(tmp_path):
    _fake_ckpt(tmp_path, "ckpt_a", "da", step=1)
    _fake_ckpt(tmp_path, "ckpt_b", "db", step=0)
    report = gc_checkpoints(str(tmp_path), {"da"}, keep_latest=0,
                            dry_run=True)
    assert [r["dir"] for r in report["retired"]] == ["ckpt_b"]
    assert (tmp_path / "ckpt_b").exists()


def test_gc_skips_inflight_tmp_dirs_and_considers_prev_rotations(
        tmp_path):
    _fake_ckpt(tmp_path, "ckpt", "dlive", step=5)
    _fake_ckpt(tmp_path, "ckpt.prev-000001", "dold", step=4)
    _fake_ckpt(tmp_path, "ckpt.tmp-1234", "dstaging", step=6)
    report = gc_checkpoints(str(tmp_path), {"dlive"}, keep_latest=0)
    assert {r["dir"] for r in report["retired"]} == {"ckpt.prev-000001"}
    assert (tmp_path / "ckpt.tmp-1234").exists()   # an in-flight save's


def test_gc_kill_window_refresh_keeps_a_just_staged_digest(tmp_path):
    """THE kill-window contract: a digest that becomes referenced
    between the GC's listing and its rm (a fleet prepare staging
    exactly this candidate) is re-checked immediately before deletion
    and KEPT."""
    _fake_ckpt(tmp_path, "ckpt_live", "dlive", step=2)
    _fake_ckpt(tmp_path, "ckpt_candidate", "dcand", step=1)
    _fake_ckpt(tmp_path, "ckpt_dead", "ddead", step=0)
    calls = []

    def refresh():
        # the fleet stages 'dcand' mid-GC: the re-poll must save it
        calls.append(True)
        return {"dlive", "dcand"}

    report = gc_checkpoints(str(tmp_path), {"dlive"}, keep_latest=0,
                            refresh=refresh)
    assert calls, "refresh was never consulted before a deletion"
    assert (tmp_path / "ckpt_candidate").exists()
    kept = {k["dir"]: k["why"] for k in report["kept"]}
    assert kept["ckpt_candidate"] == "referenced_at_delete"
    assert {r["dir"] for r in report["retired"]} == {"ckpt_dead"}


def test_gc_unreachable_refresh_fails_toward_keeping(tmp_path):
    """The reference source going unreachable at the deletion edge
    (refresh raises or returns None) must KEEP the candidate — deleting
    against the stale pre-scraped set is exactly the blind GC the
    initial scrape refuses."""
    _fake_ckpt(tmp_path, "ckpt_live", "dlive", step=1)
    _fake_ckpt(tmp_path, "ckpt_cand", "dcand", step=0)
    report = gc_checkpoints(str(tmp_path), {"dlive"}, keep_latest=0,
                            refresh=lambda: None)
    assert report["retired"] == []
    assert (tmp_path / "ckpt_cand").exists()
    kept = {k["dir"]: k["why"] for k in report["kept"]}
    assert kept["ckpt_cand"] == "reference_source_unreachable"

    def boom():
        raise OSError("fleet went away")

    report = gc_checkpoints(str(tmp_path), {"dlive"}, keep_latest=0,
                            refresh=boom)
    assert report["retired"] == [] and (tmp_path / "ckpt_cand").exists()


# -- reference gathering from /metrics snapshots ------------------------------

def test_blind_spots_counts_unobservable_replicas():
    from dsin_tpu_torch.tools.ckpt_gc import blind_spots
    assert blind_spots({}) == 0
    assert blind_spots({"info": {"replicas_unreachable": [],
                                 "replicas_stale": []}}) == 0
    # a partially-blind scrape (unreachable or stale replicas) must be
    # visible to the refusal gate: those replicas' current/prev/staged
    # digests are simply absent from the reference set
    assert blind_spots({"info": {"replicas_unreachable": [1],
                                 "replicas_stale": [2, 3]}}) == 3


def test_referenced_digests_handles_router_and_service_shapes():
    from dsin_tpu_torch.tools.ckpt_gc import referenced_digests
    router_snap = {"info": {
        "replica_digests": {"0": "h0", "1": None},
        "per_replica": {
            "0": {"serve_model_digest": {
                "digest": "cur", "prev_digest": "prv",
                "staged_digest": "stg"}},
            "1": {},
        },
    }}
    assert referenced_digests(router_snap) == {"h0", "cur", "prv",
                                               "stg"}
    service_snap = {"info": {"serve_model_digest": {
        "digest": "a", "prev_digest": None, "staged_digest": "b"}}}
    assert referenced_digests(service_snap) == {"a", "b"}
    assert referenced_digests({}) == set()


def _federation_snap(member_digests, per_member=None,
                     members_unreachable=(), members_stale=()):
    return {"info": {
        "member_digests": dict(member_digests),
        "per_member": dict(per_member or {}),
        "members_unreachable": list(members_unreachable),
        "members_stale": list(members_stale),
    }}


def test_referenced_digests_walks_the_federation_shape():
    """A federation snapshot nests whole MEMBER roll-ups
    under `per_member` — every member's replica handshake digests AND
    every replica's current/prev/staged slots must land in the
    reference set, or a federation-scoped GC deletes a checkpoint a
    member two tiers down is serving."""
    from dsin_tpu_torch.tools.ckpt_gc import referenced_digests
    snap = _federation_snap(
        {"m0": "hm0", "m1": None},
        per_member={
            "m0": {
                "replica_digests": {"0": "h00"},
                "per_replica": {"0": {"serve_model_digest": {
                    "digest": "cur0", "prev_digest": "prv0",
                    "staged_digest": "stg0"}}},
            },
            "m1": {"replica_digests": {"0": "h10"}},
        })
    assert referenced_digests(snap) == {"hm0", "h00", "cur0", "prv0",
                                        "stg0", "h10"}


def test_blind_spots_counts_both_federation_tiers():
    """An unreachable/stale MEMBER hides its whole fleet; a reachable
    member's own roll-up can still be partially blind to replicas —
    both must trip the refusal gate."""
    from dsin_tpu_torch.tools.ckpt_gc import blind_spots
    snap = _federation_snap(
        {"m0": "h"}, members_unreachable=["m2"], members_stale=["m3"],
        per_member={"m0": {"replicas_unreachable": ["1"],
                           "replicas_stale": []}})
    assert blind_spots(snap) == 3


def test_gc_kill_window_repolls_every_federation_member(tmp_path):
    """Regression: `gc_checkpoints` must consult a
    FRESH federation-wide reference set before EACH deletion. Member
    m1 stages the second candidate between the initial scan and its
    rm; the refresh (which re-polls every member, exactly like the
    tool's --metrics_url closure over a federation endpoint) must save
    it — and a refresh that can no longer see every member (a member
    partitions away mid-GC) must keep everything."""
    from dsin_tpu_torch.tools.ckpt_gc import blind_spots, referenced_digests
    _fake_ckpt(tmp_path, "ckpt_live", "dlive", step=3)
    _fake_ckpt(tmp_path, "ckpt_c1", "dc1", step=2)
    _fake_ckpt(tmp_path, "ckpt_c2", "dc2", step=1)
    members = {
        "m0": {"per_replica": {"0": {"serve_model_digest": {
            "digest": "dlive"}}}},
        "m1": {"per_replica": {"0": {"serve_model_digest": {
            "digest": "dlive"}}}},
    }
    polls = []

    def fed_snapshot():
        # every member re-polled per refresh (the federation aggregate
        # fans out to all members on each snapshot call)
        polls.append(sorted(members))
        return _federation_snap({}, per_member=members)

    def refresh():
        snap = fed_snapshot()
        if blind_spots(snap):
            return None
        refs = referenced_digests(snap)
        # first deletion edge: m1 stages dc2 mid-GC (AFTER this poll
        # answered — the NEXT edge's re-poll must see it)
        members["m1"]["per_replica"]["0"]["serve_model_digest"][
            "staged_digest"] = "dc2"
        return refs

    report = gc_checkpoints(
        str(tmp_path), referenced_digests(fed_snapshot()),
        keep_latest=0, refresh=refresh)
    assert len(polls) >= 2, "members were not re-polled per deletion"
    assert all(p == ["m0", "m1"] for p in polls)
    retired = {r["dir"] for r in report["retired"]}
    kept = {k["dir"]: k["why"] for k in report["kept"]}
    # dc1 was unreferenced at its (fresh) deletion edge: retired.
    # dc2 became referenced by m1 between the scan and its rm: KEPT.
    assert retired == {"ckpt_c1"}
    assert kept["ckpt_c2"] == "referenced_at_delete"
    assert (tmp_path / "ckpt_c2").exists()

    # now a member partitions away mid-GC: the refresh sees the blind
    # spot and fails toward keeping everything still unreferenced
    _fake_ckpt(tmp_path, "ckpt_c3", "dc3", step=0)

    def blind_refresh():
        snap = _federation_snap({}, per_member={"m0": members["m0"]},
                                members_unreachable=["m1"])
        if blind_spots(snap):
            return None
        return referenced_digests(snap)

    report = gc_checkpoints(str(tmp_path), {"dlive"}, keep_latest=0,
                            refresh=blind_refresh)
    assert report["retired"] == []
    assert (tmp_path / "ckpt_c3").exists()
    kept = {k["dir"]: k["why"] for k in report["kept"]}
    assert kept["ckpt_c3"] == "reference_source_unreachable"


def _run_tool(*args, jax_tool=False):
    """One CLI run in this process (its `main(argv)`, stdout and stderr
    captured) -> (returncode, stdout, stderr) as a subprocess gives them;
    argparse's exit 2 included."""
    import contextlib
    import io
    if jax_tool:
        sys.path.insert(0, os.path.join(REPO, "tools"))
        try:
            import ckpt_gc as tool
        finally:
            sys.path.pop(0)
    else:
        from dsin_tpu_torch.tools import ckpt_gc as tool
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = tool.main(list(args))
        except SystemExit as e:
            rc = e.code
    return subprocess.CompletedProcess(args, rc, out.getvalue(),
                                       err.getvalue())


def test_ckpt_gc_module_entry_point(tmp_path):
    """`python -m dsin_tpu_torch.tools.ckpt_gc` as an operator runs it."""
    _fake_ckpt(tmp_path, "ckpt_keep", "dk", step=1)
    _fake_ckpt(tmp_path, "ckpt_drop", "dd", step=0)
    r = subprocess.run(
        [sys.executable, "-m", "dsin_tpu_torch.tools.ckpt_gc", "--root",
         str(tmp_path), "--keep", "dk", "--keep_latest", "0"],
        capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert [x["dir"] for x in json.loads(r.stdout)["retired"]] == \
        ["ckpt_drop"]


def test_ckpt_gc_cli_smoke(tmp_path):
    _fake_ckpt(tmp_path, "ckpt_keep", "dk", step=1)
    _fake_ckpt(tmp_path, "ckpt_drop", "dd", step=0)
    r = _run_tool("--root", str(tmp_path), "--keep", "dk",
                  "--keep_latest", "0")
    assert r.returncode == 0, r.stderr[-2000:]
    report = json.loads(r.stdout)
    assert [x["dir"] for x in report["retired"]] == ["ckpt_drop"]
    assert report["referenced"] == ["dk"]
    assert not (tmp_path / "ckpt_drop").exists()
    assert (tmp_path / "ckpt_keep").exists()


def test_ckpt_gc_cli_refuses_to_gc_blind(tmp_path):
    _fake_ckpt(tmp_path, "ckpt_a", "da")
    r = _run_tool("--root", str(tmp_path))
    assert r.returncode == 2
    assert "no reference source" in r.stderr
    assert (tmp_path / "ckpt_a").exists()


def test_ckpt_gc_cli_refuses_unreachable_metrics(tmp_path):
    _fake_ckpt(tmp_path, "ckpt_a", "da")
    r = _run_tool("--root", str(tmp_path), "--metrics_url",
                  "http://127.0.0.1:1/metrics", "--timeout_s", "0.2")
    assert r.returncode == 2
    assert "refusing to GC blind" in r.stderr
    assert (tmp_path / "ckpt_a").exists()



# -- parity with the JAX package ----------------------------------------------

def _tree(root):
    """Every shape a GC walk meets, with payloads of different sizes."""
    root.mkdir()
    for k, (name, digest, step) in enumerate([
            ("ckpt", "dlive", 9), ("ckpt.prev-000001", "dprev", 8),
            ("ckpt.prev-000002", "dold2", 7), ("ckpt.tmp-77", "dtmp", 10),
            ("staged", "dstaged", 6), ("old_a", "dolda", 3),
            ("old_b", "doldb", 3), ("dup", "dolda", 1),
            ("legacy", "x", 0)]):
        d = _fake_ckpt(root, name, digest, step=step,
                       manifest=name != "legacy")
        (d / "extra.bin").write_bytes(b"y" * (100 * k + 1))
    (root / "rotted").mkdir()
    (root / "rotted" / "manifest.json").write_text("{nope")
    (root / "stray_file").write_bytes(b"z")
    return root


def _left(root):
    return sorted(os.listdir(root))


@pytest.mark.parametrize("refs,keep_latest,dry_run,refresh", [
    ({"dlive", "dstaged"}, 1, False, None),
    ({"dlive"}, 0, False, None),
    (set(), 3, True, None),
    ({"dprev"}, 0, False, "stage_olda"),
    ({"dlive"}, 0, False, "unreachable"),
    ({"dlive"}, 2, False, "raises")])
def test_gc_sets_and_bytes_equal_jax(tmp_path, refs, keep_latest, dry_run,
                                     refresh):
    """Exact: the same report (retired, kept with why, unidentified,
    bytes_freed, scanned) and the same directories left on disk."""
    scripts = {
        None: lambda: None,
        "stage_olda": lambda: (lambda: {"dolda"}),
        "unreachable": lambda: (lambda: None),
        "raises": lambda: (lambda: (_ for _ in ()).throw(
            OSError("gone"))),
    }
    src = _tree(tmp_path / "src")
    out = []
    for name, fn in (("jax", jax_ckpt.gc_checkpoints),
                     ("torch", gc_checkpoints)):
        root = tmp_path / name
        shutil.copytree(src, root)
        # the copies keep the source's mtimes: same keep_latest order
        for entry in os.listdir(src):
            st = os.stat(src / entry)
            os.utime(root / entry, (st.st_atime, st.st_mtime))
        report = fn(str(root), set(refs), keep_latest=keep_latest,
                    dry_run=dry_run, refresh=scripts[refresh]())
        out.append((report, _left(root)))
    assert out[0] == out[1]
    report = out[1][0]
    assert sorted(report["unidentified"]) == ["legacy", "rotted"]
    assert "ckpt.tmp-77" in out[1][1]


class _Canned(BaseHTTPRequestHandler):
    snapshot = {}

    def do_GET(self):  # noqa: N802 — http.server's name
        body = json.dumps(self.snapshot).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


@pytest.fixture
def metrics_url():
    _Canned.snapshot = _federation_snap(
        {"m0": "dm0"}, per_member={"m0": {
            "replica_digests": {"0": "dlive"},
            "per_replica": {"0": {"serve_model_digest": {
                "digest": "dlive", "prev_digest": "dprev",
                "staged_digest": None}}}}})
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Canned)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{server.server_address[1]}/metrics"
    server.shutdown()
    server.server_close()


@pytest.mark.parametrize("flags", [
    ("--keep", "dlive", "--keep_latest", "0"),
    ("--keep", "dlive", "--keep", "dolda", "--dry_run"),
    ("--metrics_url",),
    ("--metrics_url", "--keep", "doldb", "--keep_latest", "2")])
def test_cli_reports_equal_jax(tmp_path, metrics_url, flags):
    """Exact: the JSON the two CLIs print, and what they leave."""
    src = _tree(tmp_path / "src")
    out = []
    for jax_tool in (True, False):
        root = tmp_path / ("jax" if jax_tool else "torch")
        shutil.copytree(src, root)
        for entry in os.listdir(src):
            st = os.stat(src / entry)
            os.utime(root / entry, (st.st_atime, st.st_mtime))
        args = [a if a != "--metrics_url" else f"--metrics_url={metrics_url}"
                for a in flags]
        r = _run_tool("--root", str(root), *args, jax_tool=jax_tool)
        assert r.returncode == 0, r.stderr[-2000:]
        out.append((json.loads(r.stdout), _left(root)))
    assert out[0] == out[1]


def test_gc_against_a_port_saved_checkpoint(tmp_path):
    """The manifest digest GC reads is the one save_checkpoint wrote
    (the port's writer, two seeded models): a digest taken from a saved
    manifest protects that dir."""
    from dsin_tpu_torch.config import parse_config
    from dsin_tpu_torch.models.dsin import build_model
    from dsin_tpu_torch.train import checkpoint as ckpt_lib
    from test_train_step import tiny_ae_cfg, tiny_pc_cfg
    ae = parse_config(str(tiny_ae_cfg(crop_size=(16, 24), batch_size=1)))
    pc = parse_config(str(tiny_pc_cfg()))
    root = tmp_path / "ckpts"
    root.mkdir()
    digests = []
    for seed in (1, 2):
        state = ckpt_lib.state_from_model(build_model(
            ae.replace(AE_only=True), pc, device="cpu", seed=seed))
        d = str(root / f"ckpt_s{seed}")
        ckpt_lib.save_checkpoint(d, state)
        digests.append(ckpt_lib.load_manifest(d)["params_digest"])
    report = gc_checkpoints(str(root), {digests[0]}, keep_latest=0)
    assert [r["digest"] for r in report["retired"]] == [digests[1]]
    assert (root / "ckpt_s1").exists()
    assert not (root / "ckpt_s2").exists()
