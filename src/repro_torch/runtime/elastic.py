"""Elastic spot-instance training runtime — the paper's §4.1 reactive loop
wired to a real PyTorch training job.

The KubePACS provisioner owns the node pool; the trainer owns the model;
the **scenario engine owns the event stream**: market time, price ticks,
and interruption notices come from a ``repro_torch.sim.ClusterSim`` (the same
engine behind the figure benchmarks), so every training run is recorded to
the engine's replayable JSONL trace instead of a private market loop.
Each "provisioning epoch":

  provision → train steps → cluster.advance() emits interruption notices →
  emergency checkpoint → cache interrupted offerings → re-optimize
  (ILP × GSS minus the Unavailable Offerings Cache) → merge replacement
  capacity → restore → continue

The *cluster* is simulated (the engine emits the same event stream AWS
would), while the *training* is real, on ``device`` (the card unless the
caller names the CPU): checkpoint/restore, deterministic data resume, and
the data-shard re-partitioning on world-size change all execute for real.
Every provisioning solve runs on the process-default backend: the card's
cover-DP kernel unless the caller sets another.  Straggler
mitigation follows the paper's diversity argument plus a step-time
watchdog: offerings flagged slow are pushed through the same
UnavailableOfferingsCache path as interruptions.

The reference's loop, events and return dict; its parameters come from the
port's seeded ``init_params`` (a ``torch.Generator`` on the device, seeded
with ``seed``), and its checkpoints hold the reference's trees.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Union

import torch

from .. import optim, resolve_device
from ..configs.base import ModelConfig
from ..core import (InterruptEvent, KubePACSProvisioner, NodePool, Request,
                    SpotMarketSimulator, merge_pools)
from ..data.pipeline import DataConfig, make_batch
from ..models import transformer
from ..sim import ClusterSim
from ..train import checkpoint as ckpt
from ..train.loop import make_train_step


@dataclasses.dataclass
class ElasticConfig:
    total_steps: int = 50
    ckpt_every: int = 10
    market_check_every: int = 5
    market_hours_per_check: float = 1.0
    batch_rows: int = 8
    seq_len: int = 128
    straggler_t3_floor: int = 2      # offerings whose live T3 sinks below
    #                                  this are treated as stragglers
    keep_checkpoints: int = 3


@dataclasses.dataclass
class EpochLog:
    step: int
    event: str
    detail: Dict[str, Any]


class ElasticSpotTrainer:
    def __init__(self, cfg: ModelConfig, request: Request,
                 market: Union[SpotMarketSimulator, ClusterSim],
                 ckpt_dir: str,
                 ecfg: Optional[ElasticConfig] = None,
                 opt_cfg: Optional[optim.OptConfig] = None,
                 dcfg: Optional[DataConfig] = None, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.request = request
        # a bare market is wrapped into the engine (pressure interrupts on
        # a seed-keyed stream); passing a ClusterSim directly lets callers
        # pick the interruption model and capture the trace
        self.cluster = (market if isinstance(market, ClusterSim)
                        else ClusterSim.from_market(market, name="elastic",
                                                    interrupt_seed=seed))
        self.ckpt_dir = ckpt_dir
        self.ecfg = ecfg or ElasticConfig()
        self.opt_cfg = opt_cfg or optim.OptConfig(warmup_steps=5,
                                                  total_steps=1000)
        self.dcfg = dcfg or DataConfig(seed=seed)
        self.provisioner = KubePACSProvisioner()
        self.pool: Optional[NodePool] = None
        self.world = 1
        self.logs: List[EpochLog] = []
        self.recovery_times: List[float] = []

        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = transformer.init_params(cfg, gen, self.device)
        self.opt_state = optim.init_opt_state(self.params)
        self.step = 0
        self._train_step = make_train_step(cfg, self.opt_cfg, donate=False)
        self._step_times: List[float] = []

    # ------------------------------------------------------------------
    def provision(self) -> None:
        decision = self.provisioner.provision(self.request,
                                              self.cluster.current_snapshot())
        self.pool = decision.pool
        self.world = max(1, min(self.pool.total_pods, self.request.pods))
        self.logs.append(EpochLog(self.step, "provision", {
            "nodes": self.pool.total_nodes, "pods": self.pool.total_pods,
            "alpha": decision.alpha, "e_total": decision.metrics["e_total"],
            "hourly_cost": self.pool.hourly_cost,
            "wall_s": decision.wall_seconds,
        }))

    def _surviving_pool(self, events: List[InterruptEvent]) -> NodePool:
        lost = {}
        for ev in events:
            lost[ev.offering_id] = lost.get(ev.offering_id, 0) + ev.count
        items, counts = [], []
        for it, c in zip(self.pool.items, self.pool.counts):
            c2 = max(0, c - lost.get(it.offering.offering_id, 0))
            if c2 > 0:
                items.append(it)
                counts.append(c2)
        return NodePool(items=items, counts=counts, alpha=self.pool.alpha,
                        request=self.pool.request)

    def _handle_events(self, events: List[InterruptEvent], kind: str) -> None:
        t0 = time.perf_counter()
        # 1. emergency checkpoint (the 2-minute-notice path)
        ckpt.save_checkpoint(self.ckpt_dir, self.step, self.params,
                             self.opt_state, {"reason": kind},
                             keep=self.ecfg.keep_checkpoints)
        # 2. cache interrupted offerings + re-optimize the shortfall
        self.provisioner.clock = self.cluster.time
        self.provisioner.enqueue(events)
        survivors = self._surviving_pool(events)
        repl = self.provisioner.handle_interrupts(
            self.request, self.cluster.current_snapshot(),
            surviving_pods=survivors.total_pods)
        if repl is not None and repl.pool.total_nodes > 0:
            self.pool = merge_pools(survivors, repl.pool)
        else:
            self.pool = survivors
        old_world = self.world
        self.world = max(1, min(self.pool.total_pods, self.request.pods))
        # 3. replacement workers join: restore from the emergency checkpoint
        self.params, self.opt_state, meta = ckpt.restore_checkpoint(
            self.ckpt_dir, self.params, self.opt_state)
        recovery = time.perf_counter() - t0
        self.recovery_times.append(recovery)
        self.logs.append(EpochLog(self.step, kind, {
            "lost_nodes": int(sum(e.count for e in events)),
            "world": (old_world, self.world),
            "pods_after": self.pool.total_pods,
            "recovery_s": recovery,
        }))

    def _check_stragglers(self) -> List[InterruptEvent]:
        """Paper-consistent straggler policy: pools whose live multi-node
        capacity collapsed are demoted exactly like interrupted offerings."""
        if self.pool is None:
            return []
        snapshot = {o.offering_id: o.t3
                    for o in self.cluster.current_snapshot()}
        events = []
        for it, c in zip(self.pool.items, self.pool.counts):
            oid = it.offering.offering_id
            if c > 0 and snapshot.get(oid, 0) < self.ecfg.straggler_t3_floor:
                events.append(InterruptEvent(time=self.cluster.time,
                                             offering_id=oid, count=c,
                                             reason="straggler"))
        return events

    # ------------------------------------------------------------------
    def run(self, steps: Optional[int] = None) -> Dict[str, Any]:
        steps = steps or self.ecfg.total_steps
        # resume if a checkpoint exists (restart-after-failure path)
        last = ckpt.latest_step(self.ckpt_dir)
        if last is not None:
            self.params, self.opt_state, meta = ckpt.restore_checkpoint(
                self.ckpt_dir, self.params, self.opt_state)
            self.step = int(meta["step"])
            self.logs.append(EpochLog(self.step, "resume", {"from": last}))
        if self.pool is None:
            self.provision()

        losses = []
        while self.step < steps:
            t0 = time.perf_counter()
            # deterministic, shard-aware batch: this host plays worker 0 of
            # `world`; on rescale the shard arithmetic re-partitions rows
            batch = make_batch(self.cfg, self.dcfg, step=self.step,
                               shard=self.step % self.world, world=self.world,
                               batch=self.ecfg.batch_rows,
                               seq=self.ecfg.seq_len)
            self.params, self.opt_state, metrics = self._train_step(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            self._step_times.append(time.perf_counter() - t0)
            self.step += 1

            if self.step % self.ecfg.ckpt_every == 0:
                ckpt.save_checkpoint(self.ckpt_dir, self.step, self.params,
                                     self.opt_state, {"reason": "periodic"},
                                     keep=self.ecfg.keep_checkpoints)
            if self.step % self.ecfg.market_check_every == 0:
                # the engine advances time, records the tick to its trace,
                # and emits the interruption notices effective now.
                # NOTE: hazard exposure now matches the market step — the
                # pre-engine loop stepped the market market_hours_per_check
                # hours but sampled only 1 h of interrupt hazard, so runs
                # with market_hours_per_check > 1 see proportionally more
                # interrupts than the seed did (intentional consistency fix)
                events = self.cluster.advance(
                    self.ecfg.market_hours_per_check, self.pool.as_dict())
                if events:
                    self._handle_events(events, "interrupt")
                stragglers = self._check_stragglers()
                if stragglers:
                    self._handle_events(stragglers, "straggler")

        return {
            "losses": losses,
            "final_loss": losses[-1] if losses else float("nan"),
            "events": [dataclasses.asdict(l) for l in self.logs],
            "recovery_times": self.recovery_times,
            "interrupts_handled": sum(1 for l in self.logs
                                      if l.event in ("interrupt", "straggler")),
            "steps": self.step,
            "trace_records": len(self.cluster.recorder.records),
        }
