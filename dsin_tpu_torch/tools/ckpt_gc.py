"""Manifest-driven checkpoint GC (the port's counterpart of the JAX
package's `tools/ckpt_gc.py`, the same flags, report and exit codes).

    python -m dsin_tpu_torch.tools.ckpt_gc --root /ckpts \\
        --metrics_url http://127.0.0.1:9090/metrics?format=json
    python -m dsin_tpu_torch.tools.ckpt_gc --root /ckpts --keep aaaa --keep bbbb
    python -m dsin_tpu_torch.tools.ckpt_gc --root /ckpts ... --dry_run

It gathers the referenced digest set from a router's or a federation's
aggregated `/metrics` (every replica's CURRENT, STAGED and PREV bundle:
prev counts, since rollback re-instates it from memory but a restarted
replica can only load it from disk), then calls
`train/checkpoint.py gc_checkpoints`, which deletes ONLY directories
whose manifest `params_digest` is unreferenced and, when a metrics URL is
given, scrapes it again immediately before each deletion. Directories
without a manifest are never touched. It reads files and one HTTP
endpoint and touches no device. Exit 0 on success (retired or not), 2 on
bad arguments or unreachable metrics.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request
from typing import Set


def _walk_info(info: dict, out: Set[str]) -> None:
    """Collect every digest slot one info section (service, router
    roll-up, or federation roll-up) exposes, recursing through the
    nested tiers: `per_replica` values are per-service info sections,
    `per_member` values are whole MEMBER roll-up info
    sections that themselves carry replica_digests/per_replica."""
    def _from_model(model: dict) -> None:
        for key in ("digest", "prev_digest", "staged_digest"):
            d = model.get(key)
            if d:
                out.add(d)

    _from_model(info.get("serve_model_digest") or {})
    for d in (info.get("replica_digests") or {}).values():
        if d:
            out.add(d)
    for d in (info.get("member_digests") or {}).values():
        if d:
            out.add(d)
    for rep_info in (info.get("per_replica") or {}).values():
        _walk_info(rep_info or {}, out)
    for member_info in (info.get("per_member") or {}).values():
        _walk_info(member_info or {}, out)


def referenced_digests(snapshot: dict) -> Set[str]:
    """Every checkpoint digest ANY fleet member references, from one
    /metrics?format=json snapshot — federation-aggregated, fleet-
    aggregated (router) and single-service shapes all supported:

    * federation aggregate: `info.member_digests` plus each
      `info.per_member[name]` MEMBER roll-up, walked recursively (a
      member roll-up nests the router shape below);
    * router aggregate: `info.replica_digests` (the handshake view,
      present even for unreachable replicas) plus each
      `info.per_replica[i].serve_model_digest`'s current/prev/staged;
    * single service: `info.serve_model_digest` current/prev/staged.
    """
    out: Set[str] = set()
    _walk_info(snapshot.get("info", {}), out)
    return out


def _blind_info(info: dict) -> int:
    n = (len(info.get("replicas_unreachable") or [])
         + len(info.get("replicas_stale") or [])
         + len(info.get("members_unreachable") or [])
         + len(info.get("members_stale") or []))
    for member_info in (info.get("per_member") or {}).values():
        n += _blind_info(member_info or {})
    return n


def blind_spots(snapshot: dict) -> int:
    """Fleet members whose digests this snapshot could NOT see:
    unreachable or stale scrapes contribute only their startup
    handshake digest — their current/prev/staged slots are missing, so
    GC over such a snapshot could delete a checkpoint a live replica
    is serving. Counts BOTH tiers for a federation snapshot: an
    unreachable/stale MEMBER hides its whole fleet, and a
    reachable member's own roll-up can still be partially blind to
    some of its replicas."""
    return _blind_info(snapshot.get("info", {}))


def _scrape(url: str, timeout_s: float) -> dict:
    if "format=json" not in url:
        url += ("&" if "?" in url else "?") + "format=json"
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return json.loads(resp.read().decode("utf-8"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="retire checkpoint dirs no fleet member references")
    p.add_argument("--root", required=True,
                   help="directory whose checkpoint subdirs are "
                        "GC candidates")
    p.add_argument("--metrics_url", default=None,
                   help="a federation's or router's aggregated "
                        "/metrics (or a single service's) — scraped "
                        "for the referenced digest set, and RE-scraped "
                        "before each deletion")
    p.add_argument("--keep", action="append", default=[],
                   help="digest to keep regardless (repeatable); with "
                        "no --metrics_url this is the whole reference "
                        "set")
    p.add_argument("--keep_latest", type=int, default=1,
                   help="newest N complete checkpoints survive "
                        "regardless of references")
    p.add_argument("--timeout_s", type=float, default=5.0)
    p.add_argument("--dry_run", action="store_true",
                   help="report what would be retired, delete nothing")
    p.add_argument("--force", action="store_true",
                   help="GC even when some replicas' digests were "
                        "unobservable (unreachable/stale scrapes) — "
                        "refused by default: a partially-blind "
                        "reference set can delete a checkpoint a "
                        "hidden replica is serving")
    args = p.parse_args(argv)

    from dsin_tpu_torch.train.checkpoint import gc_checkpoints

    referenced = set(args.keep)
    refresh = None
    if args.metrics_url:
        try:
            snap = _scrape(args.metrics_url, args.timeout_s)
        except Exception as e:  # noqa: BLE001 — refusal, not a crash
            print(f"CKPT_GC_FAILED: cannot scrape {args.metrics_url}: "
                  f"{type(e).__name__}: {e} — refusing to GC blind "
                  f"(pass --keep digests to GC without a fleet)",
                  file=sys.stderr)
            return 2
        hidden = blind_spots(snap)
        if hidden and not args.force:
            # a scrape that ANSWERED can still be partially blind: an
            # unreachable/stale replica's current/prev/staged digests
            # are simply absent from the reference set
            print(f"CKPT_GC_FAILED: {hidden} replica(s) were "
                  f"unreachable/stale in the scrape — their serving "
                  f"digests are invisible, so this GC could delete a "
                  f"checkpoint they depend on; retry when the fleet "
                  f"answers, or pass --force", file=sys.stderr)
            return 2
        referenced |= referenced_digests(snap)

        def refresh():
            # at the deletion edge an unreachable or partially-blind
            # fleet returns None: gc_checkpoints then KEEPS the
            # candidate (deleting against the stale pre-scraped set
            # would be exactly the blind GC the initial scrape refuses)
            try:
                fresh = _scrape(args.metrics_url, args.timeout_s)
            except Exception:   # noqa: BLE001 — keep, never crash
                return None
            if blind_spots(fresh) and not args.force:
                return None
            return referenced_digests(fresh)
    elif not referenced:
        print("CKPT_GC_FAILED: no reference source — pass "
              "--metrics_url and/or --keep (an empty reference set "
              "would retire every unprotected checkpoint)",
              file=sys.stderr)
        return 2

    report = gc_checkpoints(args.root, referenced,
                            keep_latest=args.keep_latest,
                            dry_run=args.dry_run, refresh=refresh)
    report["referenced"] = sorted(referenced)
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
