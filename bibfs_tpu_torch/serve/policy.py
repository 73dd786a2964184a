"""Telemetry-driven adaptive routing, learned per graph digest: the
counterpart of ``bibfs_tpu/serve/policy.py``, the whole
:class:`AdaptiveRouter` unchanged.

The ladder's eligibility constants are static calibration facts
(``calibration.json``: batch crossover, push caps, the blocked
crossover). :class:`AdaptiveRouter` learns the ladder's order per graph
from what the engines measure:

- **observe** — the engines note every resolved batch
  (``note(digest, route, batch, seconds)``: an EWMA of per-query latency
  per (route, batch rung)) and periodically sample one query of a flush
  through a telemetry-enabled serial solve (``observe_levels``: push/pull
  level counts, direction flips, peak frontier fraction, also fed to the
  process ``bibfs_level_frontier_fraction`` histogram);
- **decide** — ``order(digest, batch, ladder)`` returns the ladder the
  flush walks. While any rung lacks ``min_obs`` samples near the batch
  rung it moves one under-observed rung to the front (reason
  ``explore``: fewest samples first, ties broken in reverse ladder
  order, since default traffic measures the static first rung anyway; a
  cold digest explores from the reverse end for the same reason); once
  every rung is measured it orders the rungs by measured per-query
  latency (reason ``learned``). An ineligible rung is still skipped
  whatever the order says, a rung promoted :data:`EXPLORE_CAP` times
  without a sample counts as unmeasurable, and a ladder with fewer than
  two rungs passes through unchanged (reason ``default``). Every
  decision lands in ``bibfs_routes_adaptive_total{route,reason}``;
- **persist** — with a ``path`` the learned state is a JSON sidecar
  (atomic tmp + ``os.replace`` writes, merged on save under an ``flock``
  so engines sharing one file compose) that a new router at the same
  path loads at construction and serves its first flush from. The
  engine's ``adaptive=True`` persists the policy next to a durable
  store's checkpoints (``POLICY_SIDECAR`` in its ``wal_dir``) and keeps it
  in memory otherwise.

The derived fields a policy carries per digest (the learned route order,
``push_frontier_max``: the largest frontier a push level was observed
at, and ``batch_crossover``: the smallest batch rung where a dispatch
route measured faster than the host route) are the policy triple (route
choice, push/pull threshold, batch crossover).
"""

from __future__ import annotations

import json
import os
import threading

from bibfs_tpu_torch.obs.metrics import REGISTRY
from bibfs_tpu_torch.obs.telemetry import frontier_fraction_hist
from bibfs_tpu_torch.serve.buckets import bucket_batch
from bibfs_tpu_torch.utils.annotations import guarded_by

#: decision taxonomy for ``bibfs_routes_adaptive_total{reason=}``
ADAPTIVE_REASONS = ("default", "explore", "learned")

#: sidecar filename of a durable store's policy (in its ``wal_dir``, next
#: to the checkpoint manifests)
POLICY_SIDECAR = "policy.json"

#: observations per (route, batch rung) before the ordering trusts the
#: measurement over the static ladder
MIN_OBS = 2

#: explore promotions of one rung that produced NO sample before the
#: rung is treated as unmeasurable (permanently ineligible for this
#: graph — e.g. the blocked rung on a tile-sparse digest): without the
#: cap, `under` never empties and the learned ordering never engages
EXPLORE_CAP = 3

#: EWMA weight of the newest latency sample (route warmup/compile
#: outliers wash out in a few flushes)
EWMA_ALPHA = 0.5

#: notes between sidecar writes (plus one final write at engine close)
SAVE_EVERY = 32

#: notes between telemetry-sampled serial solves (the level-shape
#: observation costs one extra serial BFS — bounded to ~1.5% of
#: flushes)
TELEMETRY_SAMPLE_EVERY = 64


@guarded_by("_lock", "_digests", "_notes", "_dirty", "_loaded", "_first",
            "_saving", "_sampling")
class AdaptiveRouter:
    """Per-graph-digest routing policy (module docstring).

    ``path`` roots the persistence sidecar (None = in-memory only);
    ``routes`` is the ladder this engine can walk (labels minted
    eagerly so the families render at zero); ``label`` the owning
    engine's metrics label.
    """

    def __init__(self, *, label: str, routes=(), path: str | None = None,
                 min_obs: int = MIN_OBS):
        self._lock = threading.Lock()
        self._digests: dict = {}
        self._notes = 0
        self._dirty = 0
        self._saving = False  # one in-flight background saver at a time
        self._sampling = False  # one in-flight telemetry sample likewise
        self._loaded = False
        # this router's first order() decision — the warm-start
        # witness (a respawned replica's first flush must already ride
        # the learned route); never persisted
        self._first: dict | None = None
        self._path = None if path is None else os.fspath(path)
        self.min_obs = int(min_obs)
        self._label = label
        family = REGISTRY.counter(
            "bibfs_routes_adaptive_total",
            "Adaptive routing decisions by chosen first rung and reason "
            "(default = static ladder, explore = measuring an "
            "under-observed rung, learned = measured ordering)",
            ("engine", "route", "reason"),
        )
        self._cells = {
            (r, why): family.labels(engine=label, route=r, reason=why)
            for r in routes
            for why in ADAPTIVE_REASONS
        }
        self._cell_family = family
        # mint the shape histogram so an adaptive process renders the
        # whole ADAPTIVE_METRIC_FAMILIES group at zero (telemetry-
        # enabled solves share the same cell)
        frontier_fraction_hist()
        if self._path is not None:
            self._load()

    # ---- persistence -------------------------------------------------
    @staticmethod
    def _sanitize(digests: dict) -> dict:
        """Coerce loaded sidecar data to the shapes the decision path
        indexes without guards — a hand-edited / version-drifted /
        partially-merged file must degrade to fewer observations, never
        to a KeyError on the flusher thread (the ``_load`` contract:
        corrupt means cold start, never a crash)."""
        clean: dict = {}
        for digest, entry in digests.items():
            if not isinstance(entry, dict):
                continue
            routes: dict = {}
            for route, buckets in (entry.get("routes") or {}).items():
                if not isinstance(buckets, dict):
                    continue
                cells = {}
                for bucket, cell in buckets.items():
                    try:
                        int(bucket)
                        lat = cell.get("lat_us")
                        cells[str(bucket)] = {
                            "lat_us": None if lat is None else float(lat),
                            "n": int(cell.get("n", 0)),
                        }
                    except (TypeError, ValueError, AttributeError):
                        continue
                if cells:
                    routes[str(route)] = cells
            clean[str(digest)] = {
                "routes": routes,
                "levels": (
                    entry.get("levels")
                    if isinstance(entry.get("levels"), dict) else None
                ),
                "last": (
                    entry.get("last")
                    if isinstance(entry.get("last"), dict) else None
                ),
            }
        return clean

    def _load(self) -> None:
        try:
            with open(self._path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError, ValueError):
            return  # absent/corrupt sidecar: cold start, never a crash
        digests = data.get("digests")
        if not isinstance(digests, dict):
            return
        digests = self._sanitize(digests)
        with self._lock:
            self._digests = digests
            self._loaded = bool(digests)

    def save(self) -> None:
        """Write the sidecar: merge our digests over whatever is on
        disk (concurrent engines over one store compose; ours wins per
        digest) and commit by atomic tmp+``os.replace`` — the file
        sits in the store's durable directory and must never be
        half-written. The read-merge-replace runs under an exclusive
        ``flock`` on a ``.lock`` sibling (per-fd, so it also
        serializes this process's close()-time save against the
        in-flight background saver): without it two writers could both
        read, then replace in turn, and the second commit would
        silently drop every digest only the first had learned. All
        file I/O runs OFF the policy lock."""
        if self._path is None:
            return
        import fcntl

        with self._lock:
            mine = json.loads(json.dumps(self._digests))  # deep snapshot
            self._dirty = 0
        # per-writer tmp name: belt to the flock's braces — even a
        # platform where the advisory lock is a no-op can never commit
        # another writer's half-written file
        tmp = f"{self._path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(f"{self._path}.lock", "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            merged = {}
            try:
                with open(self._path) as f:
                    on_disk = json.load(f)
                if isinstance(on_disk.get("digests"), dict):
                    merged = on_disk["digests"]
            except (OSError, json.JSONDecodeError, ValueError):
                pass
            merged.update(mine)
            payload = {"version": 1, "digests": merged}
            try:
                with open(tmp, "w") as f:
                    json.dump(payload, f, indent=1, sort_keys=True)
                    f.write("\n")
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self._path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise

    @property
    def loaded(self) -> bool:
        """Whether construction warm-started from a non-empty sidecar."""
        with self._lock:
            return self._loaded

    # ---- observation -------------------------------------------------
    def _entry_locked(self, digest: str) -> dict:
        e = self._digests.get(digest)
        if e is None:
            e = {"routes": {}, "levels": None, "last": None}
            self._digests[digest] = e
        return e

    @staticmethod
    def policy_key(digest: str, kind: str | None = None) -> str:
        """The per-(graph, query-kind) policy namespace: point-to-point
        stays keyed by bare digest (the pre-taxonomy sidecar format —
        old sidecars keep warm-starting), every other kind gets its own
        ``digest#kind`` entry so the msbfs ladder's learned ordering
        never leaks into the pt ladder's."""
        if kind in (None, "pt"):
            return str(digest)
        return f"{digest}#{kind}"

    def note(self, digest: str, route: str, batch: int,
             seconds: float, *, kind: str | None = None) -> bool:
        """Record one resolved batch's measured latency (``kind``
        namespaces taxonomy kinds — :meth:`policy_key`). Returns True
        when the caller should run the periodic telemetry sample
        (:meth:`observe_levels` with a fresh level-stats dict)."""
        digest = self.policy_key(digest, kind)
        per_q = float(seconds) / max(int(batch), 1) * 1e6
        bucket = str(bucket_batch(batch))
        save = False
        with self._lock:
            entry = self._entry_locked(str(digest))
            cell = (
                entry["routes"]
                .setdefault(route, {})
                .setdefault(bucket, {"lat_us": None, "n": 0})
            )
            prev = cell["lat_us"]
            cell["lat_us"] = round(
                per_q if prev is None
                else EWMA_ALPHA * per_q + (1 - EWMA_ALPHA) * prev,
                3,
            )
            cell["n"] += 1
            # a fresh sample proves the route measurable: its explore
            # promotion budget restarts (EXPLORE_CAP note in order())
            ex = entry.get("explored")
            if ex:
                ex.pop(route, None)
            self._notes += 1
            self._dirty += 1
            sample = (
                self._notes % TELEMETRY_SAMPLE_EVERY == 1
                and not self._sampling
            )
            if sample:
                # one in-flight diagnostic sample at a time — the
                # caller's background solve releases the slot via
                # sample_done(); without the guard a slow serial BFS on
                # a big graph would accumulate threads (each pinning a
                # snapshot) faster than they finish
                self._sampling = True
            if (self._path is not None and self._dirty >= SAVE_EVERY
                    and not self._saving):
                # claim the saver slot AND reset the dirty count HERE,
                # in the locked section that decides — deferring either
                # to save() would keep every subsequent note spawning
                # another saver until the first one ran
                self._saving = True
                self._dirty = 0
                save = True
        if save:
            # periodic persistence runs OFF the serving thread (note()
            # is called from the pipelined engine's one finish worker:
            # an inline read-merge-fsync-replace would queue every
            # in-flight batch behind a disk write every SAVE_EVERY
            # flushes) and best-effort like the close()-time save — a
            # full disk must not fail anything, the next note retries
            def _bg_save():
                try:
                    self.save()
                except OSError:
                    pass
                finally:
                    with self._lock:
                        self._saving = False

            threading.Thread(
                target=_bg_save, name="bibfs-policy-save", daemon=True
            ).start()
        return sample

    def sample_done(self) -> None:
        """Release the telemetry-sample slot claimed by a True return
        from :meth:`note` (the engine's background sample thread calls
        this in its ``finally``)."""
        with self._lock:
            self._sampling = False

    def observe_levels(self, digest: str, level_stats: dict,
                       n: int) -> None:
        """Fold one telemetry-enabled solve's per-level record into the
        digest's level-shape aggregate: push/pull level counts,
        direction flips, the push/pull threshold observation
        (``push_frontier_max`` — the largest frontier any push level
        carried) and the peak frontier fraction."""
        levels = level_stats.get("levels") or []
        if not levels:
            return
        pushes = sum(1 for lv in levels if lv["dir"] == "push")
        flips = sum(
            1 for a, b in zip(levels, levels[1:]) if a["dir"] != b["dir"]
        )
        push_max = max(
            (lv["frontier"] for lv in levels if lv["dir"] == "push"),
            default=0,
        )
        frac_max = max(lv["frontier"] for lv in levels) / max(int(n), 1)
        with self._lock:
            agg = self._entry_locked(str(digest)).get("levels")
            if agg is None:
                agg = {
                    "solves": 0, "levels": 0, "push_levels": 0,
                    "flips": 0, "push_frontier_max": 0,
                    "frontier_frac_max": 0.0,
                }
                self._digests[str(digest)]["levels"] = agg
            agg["solves"] += 1
            agg["levels"] += len(levels)
            agg["push_levels"] += pushes
            agg["flips"] += flips
            agg["push_frontier_max"] = max(
                agg["push_frontier_max"], push_max
            )
            agg["frontier_frac_max"] = round(
                max(agg["frontier_frac_max"], frac_max), 6
            )
            self._dirty += 1

    # ---- decision ----------------------------------------------------
    @staticmethod
    def _obs_near(routes_data: dict, route: str, bucket: str) -> dict:
        """The route's observation cell for ``bucket``, falling back to
        the NEAREST measured batch rung (by rung distance) when the
        exact one has no samples: learned orderings generalize across
        batch rungs, and a respawned replica's first flush (a deadline
        flush popping whatever arrived) rarely lands on exactly the
        rung the sidecar measured — re-exploring from scratch there
        would defeat the warm start."""
        buckets = routes_data.get(route, {})
        cell = buckets.get(bucket)
        if cell and cell["n"]:
            return cell
        target = int(bucket).bit_length()
        best = None
        for bk, c in buckets.items():
            if c["n"] and c["lat_us"] is not None:
                d = abs(int(bk).bit_length() - target)
                if best is None or d < best[0]:
                    best = (d, c)
        return best[1] if best else {"lat_us": None, "n": 0}

    def order(self, digest: str, batch: int, ladder, *,
              kind: str | None = None) -> tuple:
        """The ladder this flush walks (``host`` stays terminal) and
        why — see the module docstring's decision rules. Counted in
        ``bibfs_routes_adaptive_total{route,reason}``. ``kind``
        namespaces taxonomy kinds (:meth:`policy_key`): each kind's
        ladder — e.g. ``(msbfs, host)`` — explores and learns its own
        per-digest ordering."""
        digest = self.policy_key(digest, kind)
        rungs = [r for r in ladder if r != "host"]
        tail = [r for r in ladder if r == "host"]
        bucket = str(bucket_batch(batch))
        with self._lock:
            entry = self._digests.get(str(digest), {})
            routes = entry.get("routes", {})
            promos = entry.get("explored", {})
            obs = {r: self._obs_near(routes, r, bucket) for r in rungs}
            # the host rung is measured too (it carries sub-crossover
            # and fallback traffic); its latency anchors the learned
            # batch crossover in stats(). A rung promoted EXPLORE_CAP
            # times without producing a NEW sample (note() resets the
            # count on every sample, so a measurable rung never caps
            # out) is ineligible for this graph's traffic: treating it
            # as still-under-observed would pin the policy in the
            # explore phase forever and the measured ordering of the
            # rungs that DO serve would never engage.
            under = [
                r for r in rungs
                if obs[r]["n"] < self.min_obs
                and promos.get(r, 0) < EXPLORE_CAP
            ]
            if len(rungs) < 2:
                # nothing to reorder: the static calibration ladder
                # passes through unchanged
                out, reason = list(ladder), "default"
            elif len(under) == len(rungs) and not any(
                obs[r]["n"] for r in rungs
            ) and not self._loaded:
                # nothing measured anywhere yet: explore, starting from
                # the rung the static ladder would try LAST (reverse
                # order — the static first rung gets measured by the
                # very next default walk anyway)
                out = list(reversed(rungs)) + tail
                reason = "explore"
            elif under:
                under.sort(
                    key=lambda r: (obs[r]["n"], -rungs.index(r))
                )
                first = under[0]
                out = (
                    [first] + [r for r in rungs if r != first] + tail
                )
                reason = "explore"
            else:
                # unmeasurable rungs (capped out with zero samples)
                # sort behind every measured one
                out = sorted(
                    rungs,
                    key=lambda r: (obs[r]["lat_us"] is None,
                                   obs[r]["lat_us"] or 0.0),
                ) + tail
                reason = "learned"
            if reason == "explore":
                ex = self._entry_locked(str(digest)).setdefault(
                    "explored", {}
                )
                ex[out[0]] = ex.get(out[0], 0) + 1
            decision = {
                "digest": str(digest), "route": out[0],
                "reason": reason, "bucket": bucket,
            }
            if entry:
                entry["last"] = {
                    "route": out[0], "reason": reason, "bucket": bucket,
                }
            elif reason != "default":
                self._entry_locked(str(digest))["last"] = {
                    "route": out[0], "reason": reason, "bucket": bucket,
                }
            if self._first is None:
                self._first = decision
        cell = self._cells.get((out[0], reason))
        if cell is None:
            cell = self._cell_family.labels(
                engine=self._label, route=out[0], reason=reason
            )
            self._cells[(out[0], reason)] = cell
        cell.inc()
        return tuple(out), reason

    # ---- introspection -----------------------------------------------
    def batch_crossover(self, digest: str, default: int) -> int:
        """The learned batch crossover for this graph: the smallest
        measured batch rung where some dispatch route beat the host
        route. Falls back to ``default`` (the calibration constant)
        until both sides are measured."""
        with self._lock:
            routes = self._digests.get(str(digest), {}).get("routes", {})
            host = routes.get("host", {})
            best = None
            for route, buckets in routes.items():
                if route == "host":
                    continue
                for bucket, cell in buckets.items():
                    h = host.get(bucket)
                    if (h and h["lat_us"] is not None
                            and cell["n"] >= self.min_obs
                            and cell["lat_us"] is not None
                            and cell["lat_us"] < h["lat_us"]):
                        b = int(bucket)
                        best = b if best is None else min(best, b)
        return default if best is None else best

    def stats(self) -> dict:
        with self._lock:
            return {
                "path": self._path,
                "loaded": self._loaded,
                "notes": self._notes,
                "first_decision": (
                    None if self._first is None else dict(self._first)
                ),
                "digests": json.loads(json.dumps(self._digests)),
            }
