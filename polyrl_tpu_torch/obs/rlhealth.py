"""Training health plane: the RL-dynamics ledger (a copy of
``polyrl_tpu/obs/rlhealth.py``).

The systems plane is fully observable (traces, goodput, engine flight
deck) but the *algorithmic* plane was scalars-only: ``actor/approx_kl``,
``actor/entropy`` and a TIS weight mean — an entropy collapse, a KL
blowup, or a batch full of zero-advantage GRPO groups stayed invisible
until the reward curves died. The ledger turns each training step's
already-computed arrays into distributions and group diagnostics:

- **distributions** (log2 :class:`~polyrl_tpu_torch.obs.histogram.Histogram`,
  emitted as ``training/<name>/{p50,p95,p99,max,mean,count}``):
  ``training/adv_abs`` (|advantage| over masked tokens),
  ``training/tis_weight`` (per-token truncated importance weights),
  ``training/logprob_delta_abs`` (|old − rollout| logprob disagreement),
  ``training/response_len`` (per trajectory), and ``training/staleness``
  — the per-token weight-version lag (current push version minus the
  version that sampled the token, from the wire-carried
  ``output_token_weight_versions``). The staleness ledger is what the
  fully-async (``trainer.staleness_limit`` k>1) pipeline trains against:
  per-token TIS over mixed-version sequences is tuned by exactly this
  distribution, and the mixed-version TIS pass feeds back
  ``training/tis_unknown_version_tokens`` (tokens excluded from
  correction because their version is unknown) plus per-version-lag
  ``training/tis_weight_mean/lag<k>`` / ``training/tis_clip_frac/lag<k>``
  gauges.
- **GRPO group diagnostics** (gauges): ``training/degenerate_group_frac``
  (zero-reward-variance groups — their advantages are identically 0, the
  batch fraction that teaches nothing), ``training/effective_batch_frac``
  (trajectories with any nonzero masked advantage),
  ``training/truncated_frac`` / ``training/empty_response_frac`` (budget
  exhaustion / dropped-abort holes), and per-data-source reward
  ``training/reward_mean/<src>`` + ``training/reward_std/<src>``.
- **mirrors** (gauges): ``training/{entropy,approx_kl,grad_norm,
  tis_clip_frac}`` copied from the step's actor metrics so the
  FlightRecorder's direction-aware watch and the /statusz ``training``
  section read one namespace.

The ledger is fed per ibatch from ``StreamRLTrainer._process_ibatch``
(host numpy arrays the step already copied off the device — no extra
device work and no extra synchronisation) and finalized once per
step; a bounded tail of per-step rows plus the last batch's group table
back the /statusz ``training`` section and the flight recorder's
``training.json`` post-mortem bundles. Thread-safe: the statusz exporter
snapshots from its HTTP thread while the fit loop accounts.
"""

from __future__ import annotations

import collections
import re
import threading

from polyrl_tpu_torch.obs.histogram import Histogram

_MISSING = object()
_SLUG_RE = re.compile(r"[^a-z0-9_.]+")

# per-step histogram names (emitted under training/<name>)
HIST_NAMES = ("adv_abs", "tis_weight", "logprob_delta_abs",
              "response_len", "staleness")

# step-metric mirrors: training/<out> <- first present actor key. One
# namespace for the health plane: the recorder watch, statusz section and
# bench extras all read training/* without knowing actor internals.
MIRRORS = (
    ("entropy", ("actor/entropy", "actor/entropy_rollout")),
    ("approx_kl", ("actor/approx_kl",)),
    ("grad_norm", ("actor/grad_norm",)),
    ("tis_weight_mean", ("actor/tis_weight_mean",)),
    ("tis_clip_frac", ("actor/tis_clip_frac",)),
)


def _slug(source) -> str:
    """Data-source name → metric-key segment (lowercase [a-z0-9_.])."""
    s = _SLUG_RE.sub("_", str(source or "default").lower()).strip("_")
    return s or "default"


class TrainingHealthLedger:
    """Per-step RL-dynamics accounting: observe per-ibatch arrays, finalize
    once per step into ``training/*`` gauges + histograms, keep a bounded
    tail for /statusz and post-mortem bundles."""

    def __init__(self, tail_steps: int = 64, max_group_rows: int = 64,
                 max_sources: int = 16):
        self.tail_steps = tail_steps
        self.max_group_rows = max_group_rows
        self.max_sources = max_sources
        self.steps = 0
        self.tail: collections.deque = collections.deque(maxlen=tail_steps)
        self._lock = threading.Lock()
        self._last: dict[str, float] = {}
        self._last_groups: list[dict] = []
        self._reset_window()

    def _reset_window(self) -> None:
        self._hists = {name: Histogram() for name in HIST_NAMES}
        self._adv_n = 0
        self._adv_sum = 0.0
        self._adv_sumsq = 0.0
        self._adv_zero = 0
        self._groups = 0
        self._groups_degenerate = 0
        self._traj = 0
        self._traj_effective = 0
        self._traj_truncated = 0
        self._traj_empty = 0
        self._tok_masked = 0
        self._tok_known_version = 0
        self._tok_stale = 0
        self._staleness_max = 0
        # mixed-version TIS accounting (trainer passes the stats dict from
        # core_algos.mixed_version_importance_weights): unknown-version
        # tokens excluded from correction, and per-version-lag raw sums
        # lag -> [tokens, weight_sum, clipped]
        self._tis_seen = False
        self._tis_unknown = 0
        self._tis_lag: dict[int, list] = {}
        self._lp_delta_sum = 0.0
        self._lp_delta_n = 0
        # per-source reward moments: slug -> [n, sum, sumsq]
        self._sources: dict[str, list[float]] = {}
        self._group_rows: list[dict] = []

    # -- per-ibatch feed ----------------------------------------------------

    def observe_ibatch(self, *, advantages, response_mask, group_ids,
                       traj_rewards, data_sources=None,
                       old_log_probs=None, rollout_log_probs=None,
                       tis_weights=None, tis_stats=None,
                       weight_versions=None,
                       current_version=None,
                       max_response_length: int = 0) -> None:
        """Fold one processed ibatch into the current step window. All
        arguments are host numpy arrays the trainer already computed —
        ``weight_versions`` is the per-token ``rollout_weight_versions``
        tensor (−1 = version unknown on that token) and
        ``current_version`` the rollout plane's current push version the
        lag is measured against."""
        import numpy as np

        adv = np.asarray(advantages, np.float64)
        mask = np.asarray(response_mask, np.float64) > 0
        gids = np.asarray(group_ids).ravel()
        rewards = np.asarray(traj_rewards, np.float64).ravel()
        lens = mask.sum(axis=-1)
        tok_adv = adv[mask]
        eff = (np.abs(np.where(mask, adv, 0.0)).max(axis=-1) > 1e-12
               if adv.size else np.zeros(0, bool))

        with self._lock:
            h = self._hists
            h["adv_abs"].observe_many(np.abs(tok_adv))
            h["response_len"].observe_many(lens)
            self._adv_n += int(tok_adv.size)
            self._adv_sum += float(tok_adv.sum())
            self._adv_sumsq += float((tok_adv * tok_adv).sum())
            self._adv_zero += int((np.abs(tok_adv) <= 1e-12).sum())
            self._tok_masked += int(mask.sum())
            self._traj += int(len(rewards))
            self._traj_effective += int(eff.sum())
            if max_response_length > 0:
                self._traj_truncated += int((lens >= max_response_length).sum())
            self._traj_empty += int((lens == 0).sum())

            if old_log_probs is not None and rollout_log_probs is not None:
                delta = (np.asarray(old_log_probs, np.float64)
                         - np.asarray(rollout_log_probs, np.float64))[mask]
                h["logprob_delta_abs"].observe_many(np.abs(delta))
                self._lp_delta_sum += float(delta.sum())
                self._lp_delta_n += int(delta.size)

            if tis_weights is not None:
                h["tis_weight"].observe_many(
                    np.asarray(tis_weights, np.float64)[mask])

            if tis_stats is not None:
                # mixed-version TIS breakdown: unknown-version exclusions
                # (training/tis_unknown_version_tokens) and per-lag
                # weight/clip sums (training/tis_{weight_mean,
                # clip_frac}/lag<k> at finalize)
                self._tis_seen = True
                self._tis_unknown += int(tis_stats.get("unknown_tokens", 0))
                for lag, row in (tis_stats.get("per_lag") or {}).items():
                    agg = self._tis_lag.setdefault(int(lag), [0, 0.0, 0])
                    agg[0] += int(row["tokens"])
                    agg[1] += float(row["weight_sum"])
                    agg[2] += int(row["clipped"])

            if weight_versions is not None and current_version is not None:
                wv = np.asarray(weight_versions)
                known = mask & (wv >= 0)
                lag = np.maximum(int(current_version) - wv[known], 0)
                h["staleness"].observe_many(lag)
                self._tok_known_version += int(known.sum())
                self._tok_stale += int((lag > 0).sum())
                if lag.size:
                    self._staleness_max = max(self._staleness_max,
                                              int(lag.max()))

            # group table: reward spread, response shape and staleness per
            # GRPO group — the "what was this batch made of" view the
            # post-mortem bundle carries
            srcs = (list(data_sources) if data_sources is not None
                    else [""] * len(rewards))
            for g in np.unique(gids):
                sel = gids == g
                r = rewards[sel]
                degenerate = bool(r.size < 2 or (r.max() - r.min()) <= 1e-9)
                self._groups += 1
                self._groups_degenerate += int(degenerate)
                if len(self._group_rows) < self.max_group_rows:
                    glens = lens[sel]
                    row = {
                        "group": int(g), "size": int(r.size),
                        "reward_mean": round(float(r.mean()), 4),
                        "reward_std": round(float(r.std()), 4),
                        "degenerate": degenerate,
                        "len_mean": round(float(glens.mean()), 1),
                        "truncated": int((glens >= max_response_length).sum())
                        if max_response_length > 0 else 0,
                        "data_source": str(srcs[int(np.argmax(sel))] or ""),
                    }
                    if weight_versions is not None and \
                            current_version is not None:
                        gv = np.asarray(weight_versions)[sel]
                        gk = (np.asarray(response_mask)[sel] > 0) & (gv >= 0)
                        row["staleness_max"] = (
                            int(max(int(current_version) - gv[gk].min(), 0))
                            if gk.any() else 0)
                    self._group_rows.append(row)

            for src, rew in zip(srcs, rewards):
                slug = _slug(src)
                if slug not in self._sources and \
                        len(self._sources) >= self.max_sources:
                    slug = "other"
                mom = self._sources.setdefault(slug, [0.0, 0.0, 0.0])
                mom[0] += 1
                mom[1] += float(rew)
                mom[2] += float(rew) * float(rew)

    # -- per-step close -----------------------------------------------------

    def finalize_step(self, step: int, metrics=None
                      ) -> tuple[dict[str, float], dict[str, Histogram]]:
        """Close the step window: returns ``(gauges, histograms)`` for the
        step record (``metrics`` is the step's MetricsTracker, read for the
        actor-metric mirrors), appends the compact tail row, and resets
        the window for the next step."""
        with self._lock:
            gauges: dict[str, float] = {}
            n = max(self._adv_n, 1)
            mean = self._adv_sum / n
            var = max(self._adv_sumsq / n - mean * mean, 0.0)
            gauges["training/adv_mean"] = mean
            gauges["training/adv_std"] = var ** 0.5
            gauges["training/adv_zero_frac"] = self._adv_zero / n
            gauges["training/degenerate_group_frac"] = (
                self._groups_degenerate / self._groups if self._groups
                else 0.0)
            gauges["training/groups"] = float(self._groups)
            traj = max(self._traj, 1)
            gauges["training/effective_batch_frac"] = (
                self._traj_effective / traj)
            gauges["training/truncated_frac"] = self._traj_truncated / traj
            gauges["training/empty_response_frac"] = self._traj_empty / traj
            gauges["training/logprob_delta_mean"] = (
                self._lp_delta_sum / self._lp_delta_n
                if self._lp_delta_n else 0.0)
            tok = max(self._tok_masked, 1)
            gauges["training/staleness_known_frac"] = (
                self._tok_known_version / tok)
            gauges["training/staleness_frac_stale"] = (
                self._tok_stale / self._tok_known_version
                if self._tok_known_version else 0.0)
            gauges["training/staleness_max"] = float(self._staleness_max)
            if self._tis_seen:
                gauges["training/tis_unknown_version_tokens"] = float(
                    self._tis_unknown)
                for lag in sorted(self._tis_lag):
                    n, ws, cl = self._tis_lag[lag]
                    if n:
                        gauges[f"training/tis_weight_mean/lag{lag}"] = ws / n
                        gauges[f"training/tis_clip_frac/lag{lag}"] = cl / n
            for slug, (cnt, tot, sq) in self._sources.items():
                smean = tot / cnt
                gauges[f"training/reward_mean/{slug}"] = smean
                gauges[f"training/reward_std/{slug}"] = (
                    max(sq / cnt - smean * smean, 0.0) ** 0.5)
            if metrics is not None:
                for out, keys in MIRRORS:
                    for key in keys:
                        v = metrics.get(key, _MISSING)
                        if v is not _MISSING:
                            gauges[f"training/{out}"] = float(v)
                            break
            hists = {f"training/{name}": hist
                     for name, hist in self._hists.items() if hist.count}

            row = {"step": int(step)}
            for short, key in (
                    ("entropy", "training/entropy"),
                    ("approx_kl", "training/approx_kl"),
                    ("grad_norm", "training/grad_norm"),
                    ("tis_clip_frac", "training/tis_clip_frac"),
                    ("degenerate_group_frac",
                     "training/degenerate_group_frac"),
                    ("effective_batch_frac",
                     "training/effective_batch_frac"),
                    ("adv_std", "training/adv_std"),
                    ("staleness_max", "training/staleness_max"),
                    ("staleness_frac_stale",
                     "training/staleness_frac_stale")):
                if key in gauges:
                    row[short] = round(gauges[key], 6)
            st = self._hists["staleness"]
            if st.count:
                row["staleness_p95"] = round(st.percentile(95.0), 3)
            if self._sources:
                tot_n = sum(m[0] for m in self._sources.values())
                tot_s = sum(m[1] for m in self._sources.values())
                row["reward_mean"] = round(tot_s / max(tot_n, 1), 4)
            self.tail.append(row)
            self.steps += 1
            self._last = dict(gauges)
            if self._group_rows:
                self._last_groups = list(self._group_rows)
            self._reset_window()
            return gauges, hists

    # -- views (statusz / post-mortem) --------------------------------------

    def snapshot(self) -> dict:
        """The /statusz ``training`` section: last finalized gauges + a
        short trend tail (full tail + group table live in bundle_view)."""
        with self._lock:
            return {"steps": self.steps,
                    "last": dict(self._last),
                    "tail": list(self.tail)[-16:]}

    def bundle_view(self) -> dict:
        """``training.json`` for flight-recorder bundles: the full ledger
        tail plus the last batch's group table."""
        with self._lock:
            return {"steps": self.steps,
                    "last": dict(self._last),
                    "tail": list(self.tail),
                    "last_groups": list(self._last_groups)}
