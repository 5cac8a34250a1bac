#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (ble_tpu_torch) on one NVIDIA GPU and holds
each of its hand-written CUDA kernels against its plain PyTorch version.

  python3 chip_smoke.py                    # every phase below
  python3 chip_smoke.py --phases build,kernels

Phases (each raises on a failure, so the exit code is then not 0):
  device     requires CUDA; prints the card's name and power limit.
  build      compiles every csrc/*.cu for sm_90a, one nvcc each, in
             parallel, and prints ptxas's registers, stack frame and spills
             of each kernel, each GP kernel's shared memory and CTAs a SM
             (for B3's cluster kernel at each cluster size also the
             clusters resident at once), and the FMA and shared-load counts
             of its SASS.
  kernels    each kernel against its plain version on the same CUDA
             inputs: B1, the physics substeps, at E = 1, 7, 131 (one env a
             CTA) and 4096 (32 a CTA) and 18 substeps on states from the
             port's own reset; B2, the GP window, at E = 4096 for K = 1
             and K = 8 on a GP state warmed through expiries and ring
             wraparound; the GP observe through its cluster path at E = 1,
             2 and 7 (B3) and its one-CTA-an-env path at E = 4096 (B4),
             with disabled envs; the column query (B5) at E = 1, 7, 131 and
             4096 (the edges of its level split) at N = 181 and 37, and on
             empty states (exactly 0); and the 960-step churn-drift track
             through B3. Each check logs the split its launch used.
  reference  an 8-env, 32-step StationSeeker eval on the card (kernels)
             against the same eval on the CPU (plain versions).
  worlds     seed-to-world parity with the JAX package, which this machine
             lacks, through its values in tests/torch_jax_worlds.json: the
             reset keys and initial conditions of tiny_eval's seeds and of
             each strata list's first seed, a 64-bit seed's keys, four
             seeds' latents, the fallback decoder's weights, the random
             agent's actions over 64 steps and parity_reset(0)'s noise
             lattices (compare_worlds' tolerances); the 8-seed, 30-step
             StationSeeker eval on the generative field with B1 and B2
             launched every step, against JAX's rewards, time within
             radius and final timesteps; random_walk's seed 1 alone, in
             the batch [0, 1] and in shard 1 of a two-shard eval, equal in
             bits; 32 parity-mode steps of one env, card against CPU; the
             reset of 4096 seeds and the fallback decoder's init timed.
  gym        this slice's path: BalloonEnv(wind_field='generative'), 128
             StationSeeker steps through env.step at a batch of one; B1,
             B3 and B5 launch once a step; the first 16 steps against the
             same env on the CPU; the step's wall time and device share;
             then, untimed, 16 steps of another BalloonEnv on the card
             with a MatplotlibRenderer, whose recorded track must equal
             the balloon states read out after the reset and each step
             (render() is not called: the image is the CPU tests').
  pair       env.step (B1, B4, B5) against step_batched (B1, B2) from the
             same state, E = 4096 on per-env generative fields, 8 steps.
  main       the main path: the StationSeeker eval over E = 4096 envs,
             each on its own VAE-decoded field, slab cache on, 128 steps
             (two exact GP refreshes, sixteen slab re-centres); B1 and B2
             must launch every step, the observations stay finite and the
             time within radius lies in [0, 1]. Run twice from one
             initial state: the first run is counted, the second timed.
  api        the functions of the JAX package's public API that reach
             the card's kernels outside the main path: (a)
             features.wind_column_features at E = 4096 on main's reset
             state launches B5 once, equals get_features' column block in
             bits, and its GP query is within B5_ATOL of the same call on
             the CPU; its time by CUDA events; (b) the training CLI
             (--agent quantile, no --device, TrainConfig's defaults: 8 x
             600, 51 atoms, 1024 generative envs) for two iterations of 8
             env steps with --eval_every 1 on micro_eval (one seed, 960
             steps): two learning_curve.jsonl records with the JAX
             package's keys, B1 and B2 launched every eval step, the last
             record's TWR and reward equal to a re-evaluation of the final
             checkpoint's network (the eval CLI, that is
             eval_lib.evaluate over learner.make_eval_policy, at the same
             batch, beside the last eval); the eval's env-steps/s.
  params     step_batched's own slab cadence: 16 steps of
             step_batched(global_step=t) with field_cache_every = 4 from
             main's reset state (E = 4096) launch B1 and B2 once a step,
             leave no balloon outside its slab and equal in bits the same
             steps with refresh='never' and a re-centre by hand every 4
             steps. With phase kernels, B1 and B2 are also checked at
             this path's inputs.
  window     the window route: env.rollout_window at K = 8 from main's
             initial state (E = 4096, generative fields, slab cache on):
             one window against 8 step_batched calls from the same state
             (rewards, done flags, info, positions, winds, active slots
             and counts equal; observations within 2e-4, kinv 5e-3), from
             the reset and again after 128 steps; 16 windows (128 steps)
             with B1 launched 8 times and B2 once a window, observations
             finite and rewards in [0, 1], then the same windows timed;
             then `python -m ble_tpu_torch.bench` in its window and
             perstep modes at its defaults (4096 envs, on the card), each
             printing one JSON line. With phase kernels, B1 and B2 (K = 8)
             are also checked on the window run's own state and inputs.
  train      the training path at full width: QR-DQN (8 x 600, 51
             atoms) over E = 1024 generative envs, replay ring 512,
             batch 32, 256 train steps an env step, MarcoPolo on; two
             chunks of 8 env steps with a selective reset between them;
             B1 and B2 must launch every env step, train_steps must be 256
             x the env steps at which replay could sample, losses finite;
             then env-steps/s, gradient steps/s, the learner's and the
             env's ms an env step, one env step under torch.profiler
             (host ms by part, device ms, launches, busy share), one
             train step on the card against the CPU (parameters,
             gradients and the step's update, beside two faulty steps
             that must break a limit: TF32 matmuls, a rate 1.1 times too
             large), a full and a light checkpoint round trip, and the
             training CLI (--agent quantile, no --device) for one
             iteration of 8 env steps and again, resuming from its
             checkpoint. With phase kernels, B1 and B2 are also checked
             at E = 1024 on the train run's own state.
  agents     the other trainable agents at full width over E = 1024
             generative envs, MarcoPolo on, each from its own TrainState
             around one reset: dqn (8 x 600 MLP), finetune_perciatelli
             (the QR-DQN network; no blob, so a random init), mlp (one
             linear layer) and r2d2 (2 x 600 torso, LSTM 256, duelling 51
             atoms); a chunk of 8 env steps (mlp and r2d2 then a selective
             reset whose envs must lose their lanes; r2d2 a second chunk),
             2 steps with the learner timed apart and one under
             torch.profiler (mlp and r2d2; dqn's and finetune's run
             unprofiled, as quantile's is profiled in phase train). B1
             and B2 must launch every env step,
             train_steps match each agent's count (dqn and finetune 256,
             r2d2 16 an env step once replay can sample, mlp one SGD step
             every env step), losses finite, the online parameters moved,
             replay.total the steps; each prints env-steps/s, gradient
             steps/s, learner ms an env step, launches a train step and
             peak memory. Then one train step card vs CPU for dqn and
             r2d2 with phase train's limits and controls, the r2d2 train
             CLI for one iteration and the eval CLI on its checkpoint
             (micro_eval's seed, cut to 128 steps for the time limit),
             and Perciatelli44 from synthetic parameters on
             the card. With phase kernels, B1 and B2 are also checked at
             E = 1024 on the r2d2 run's own state.
  distributed
             the data-parallel trainer and the sharded eval, each process
             group in worker processes (`chip_smoke.py --worker ...`) that
             end with their part. (a) `distributed_train --n_devices 1`
             (world 1, NCCL) at TrainConfig's defaults over E = 1024
             generative envs, one chunk of 8 env steps with a checkpoint:
             B1 and B2 every env step and one all-reduce a train step (its
             JSON line), train_steps 256 x the steps that could sample,
             finite losses, the learner against a single-process
             run_episode_chunk from the same seed (phase train's limits;
             whether the bits are equal is printed), env-steps/s, gradient
             steps/s and the all-reduce's share of a train step under
             torch.profiler beside phase train's, then the eval CLI
             (--agent quantile, micro_eval cut to 128 steps) on the
             checkpoint. (b) two
             ranks of 64 envs on the one card over gloo (NCCL refuses two
             ranks on one GPU) against one process of 128: greedy,
             MarcoPolo off, no learning, a forced selective_reset;
             observations, pressure, replay rows, counters and world seeds
             equal in bits; then with learning on every parameter within
             1e-6 of the ranks' mean. (c) eval_lib on 16 seeds for 64
             StationSeeker steps: two --num_shards 2 slices merged by
             combine_shard_results equal the unsharded run. (d) the
             tensor-parallel demo on a (1, 1) mesh over NCCL: 10 finite,
             falling losses. B1 and B2 are also checked against their plain
             versions on (a)'s final state and last B2 inputs in its
             worker, and timed there with phase timing (the
             physics_distributed and gp_window_distributed rows).
  vae        the wind VAE's trainer at full width (88 M parameters), on
             no kernel of the port (its products are cuBLAS GEMMs, as the
             JAX package's are XLA's): (a) one train step at batch 16 on
             the card against the CPU from the same parameters, batch and
             noise, to VAE_STEP_LIMITS, beside the TF32 and 1.1 x rate
             controls that must break one; (b) the 3-step seed-0
             run (synthetic reservoir, batch 2) against the JAX package's
             metrics in tests/torch_jax_vae.json, within VAE_FIXTURE_RTOL;
             (c) the CLI (`python -m ble_tpu_torch.generative.train_vae
             --synthetic`, no --device) for 20 batches of 16 as a
             subprocess beside (a) and (b): exit 0, finite metrics, its
             checkpoint read back in bits, the printed evaluation
             recomputed from it, its decoder loaded into vae.Decoder;
             (d) train steps/s at batch 16 (the step alone, and train()'s
             loop body with the reservoir's draw), launches and busy share
             of a step under torch.profiler, peak memory.
  timing     each kernel at its path's shapes with CUDA events, beside its
             plain version, a library call where one computes the same
             function or its dominant term, and its bound; for B1, B3, B4
             and B5 also the kernels' own device time under torch.profiler
             (at E = 1 the events time the host's launch path), and for
             the library calls of B3, B4 and B5 theirs; for B2 and B5 at
             4096 the SM clock and power under load.
  numerics   (not in the default set) B1's kernel, its plain version on
             the card and on the CPU against each other after 1 and 18
             substeps.
  calibrate  (not in the default set) B2 at K = 8 against its plain
             version over eight seeds, beside two wrong versions: the
             readings behind B2_K8_ATOL.
  profile    (not in the default set) torch.profiler over 16 steps of the
             main path: time by operator on the device and on the host,
             and the device's busy share.
  tile       (not in the default set) the GP query engine's product loop
             alone in four forms (csrc/bench/product_tile.cu): what bounds
             it, shared loads or FMAs.
  splits     (not in the default set) the device time of the designs the
             kernels' splits choose between: B3 at E = 1 and 7 on one CTA
             an env and on clusters of 2, 4 and 8; B1 at E = 4096 with 8,
             16 and 32 envs a CTA.

The generative fields come from the VAE decoder's deterministic fallback
(models/loader.py): no trained decoder is in the repository.

Prints the kernels' JSON line and the nvidia-smi line, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
import types

import numpy as np
import torch

DEV = 'cuda'
E = 4096
MAIN_STEPS = 128
DEFAULT_PHASES = ('device', 'build', 'kernels', 'reference', 'worlds', 'gym',
                  'pair', 'main', 'api', 'params', 'window', 'train',
                  'agents', 'distributed', 'vae', 'timing')
# Phase worlds: the seeds and steps of its StationSeeker eval and of the
# random agent's actions held against the JAX package's values
# (tests/torch_jax_worlds.json, written by tests/test_torch_worlds.py). The
# eval's 30 steps are those of the CPU eval test, whose one compiled JAX
# eval program also gives the fixture's.
WORLDS_SEEDS = list(range(8))
WORLDS_STEPS = 30
WORLDS_ACTION_STEPS = 64
WORLDS_FIXTURE = 'tests/torch_jax_worlds.json'
# Its parity-mode run: one env, card against CPU.
WORLDS_PARITY_STEPS = 32
# Its timed reset.
WORLDS_RESET_E = 4096
# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W):
# float32 on the CUDA cores and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# The JAX package's tolerance for its physics kernel against its plain
# version, tests/test_pallas_physics.py:45-54: |kernel - plain| <= atol +
# rtol |plain| per field (atol 1e-2 where none is listed). Near buoyant
# equilibrium the sign of rho V - M flips on an ulp, so pressure differs by
# a few Pa after 18 substeps between any two float32 evaluation orders. The
# golden trajectory's bounds (tests/test_golden_trajectory.py:118-126,
# pressure 1 Pa, superpressure 2 Pa, mols_air 0.2) hold one evaluation
# order against a fixture and are not used here: on an H100 the kernel
# reads 2.65 Pa and 2.12 Pa from the plain version, and the plain version
# on the card and on the CPU differ by 9.92 Pa on the same inputs (phase
# numerics; PERF.md, PR 1).
B1_ATOL = {'pressure_pa': 2.0, 'superpressure_pa': 2.0,
           'battery_charge_j': 500.0, 'x_m': 2.0, 'y_m': 2.0,
           'envelope_volume_m3': 0.5, 'mols_air': 1.0}
B1_RTOL = 5e-4
# Some worlds are ill-conditioned there: on the JAX package's worlds of
# seeds 0-4095, moving every float input of the plain version one ulp
# moves its pressure after 18 substeps by up to 18.64 Pa on an H100, past
# the fixed limits, which then cannot tell a sound kernel from a wrong
# one (the kernel read 18.64 Pa from the plain version there, the plain
# version 19.91 Pa apart on the card and the CPU; PERF.md §6). So each
# env and field is also allowed B1_SENS_FACTOR times the plain version's
# own one-ulp response (b1_sensitivity). A control holds the check to its
# purpose: the plain version with a payload mass 1e-4 too large must break
# it (check_b1 at the main path's 4096 envs).
B1_SENS_FACTOR = 4.0
B1_CONTROL_PAYLOAD = 1.0 + 1e-4
# tests/test_pallas_gp_window.py's tolerance for kinv, alpha and levels.
B2_ATOL = 5e-3
# At K = 8, with the ring evicting a live point every step, the incremental
# kinv and alpha of any two float32 summation orders drift apart by more
# than that. These fixed limits lie between the largest kernel - plain
# reading over eight seeds on an H100 (kinv 8.6e-3, alpha 1.48e-2) and the
# nearest reading of a wrong version (the plain version with TF32 matmuls
# after one step: kinv 0.17, alpha 0.35; after eight it blows up past
# 1e15); phase calibrate, PERF.md, PR 1.
B2_K8_ATOL = {'kinv': 2e-2, 'alpha': 4e-2}


def log(*args):
  print(*args, flush=True)


def nvidia_smi_line() -> str:
  return subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], check=True, capture_output=True,
      text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
  """Mean milliseconds of fn() on the current stream, by CUDA events."""
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def kernel_device_ms(fn, reps: int = 50):
  """Milliseconds of CUDA kernels one call of fn() runs on the card, by
  torch.profiler (CUPTI) over `reps` calls: the kernels' own time, without
  the host's launch path, which CUDA events over back-to-back calls of a
  small kernel measure instead. A short session can lose kernel records
  (on some H100 hosts a session kept 58-64 % of its launches and read
  that share of the time), so of three sessions only
  those that recorded a whole number of launches a call count, and of
  those the one with the most launches, the lower time between equals.
  None, with the sessions logged, if no session counts."""
  fn()
  torch.cuda.synchronize()

  def run():
    for _ in range(reps):
      fn()
    torch.cuda.synchronize()

  readings = [device_time(run, reps)[:2] for _ in range(3)]
  whole = [r for r in readings
           if r[1] >= 1 and abs(r[1] * reps - round(r[1]) * reps) < 0.5]
  if not whole:
    log('device time: no session recorded whole launches a call; '
        f'(ms, launches a call): {readings}')
    return None
  return max(whole, key=lambda r: (r[1], -r[0]))[0]


def clock_under_load(fn, seconds: float = 2.0) -> dict:
  """The SM clock (MHz) and board power (W) nvidia-smi samples every 100 ms
  while fn() runs back to back for `seconds`: the medians over the samples
  taken under load."""
  proc = subprocess.Popen(
      ['nvidia-smi', '--query-gpu=clocks.sm,power.draw',
       '--format=csv,noheader,nounits', '-lms', '100'],
      stdout=subprocess.PIPE, text=True)
  try:
    time.sleep(0.5)
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
      for _ in range(20):
        fn()
      torch.cuda.synchronize()
  finally:
    proc.terminate()
    out = proc.communicate()[0]
  samples = []
  for line in out.splitlines():
    try:
      samples.append([float(x) for x in line.split(',')])
    except ValueError:
      continue
  samples = samples[len(samples) // 4:]  # the first ones precede the load
  if not samples:
    return {}
  return {'sm_clock_mhz': float(np.median([c for c, _ in samples])),
          'power_w': float(np.median([w for _, w in samples]))}


def check(ok: bool, what: str) -> None:
  if not ok:
    raise AssertionError(what)


# ---------------------------------------------------------------- B1 ------


# Operations of one substep of csrc/physics.cu, counted by hand from its
# source, function by function, as (fp32, mufu, alu): each float add,
# subtract and multiply is one fp32 flop; each division, sqrtf, expf,
# logf, sinf and cosf is at least one special-function (MUFU) result (the
# accurate versions add float work on top, which is not counted); each
# compare, select, min, max, abs, floor, trunc, conversion and int32
# operation is one ALU op. Loop-invariant constants are not counted and
# common subexpressions count once; of at_pressure's two height formulas
# the cheaper (log) one. Both sides of a branchless select count, as the
# kernel computes both.
B1_SUBSTEP_OPS = {
    'advection, buoyancy, ascent, dp/dt': (26, 6, 6),
    'at_pressure_temperature': (6, 3, 17),
    'latlng_from_offset': (125, 16, 71),
    'solar_calculator with days_from_j2000': (205, 47, 185),
    'd_balloon_temperature_dt': (75, 27, 21),
    'superpressure and volume': (17, 3, 3),
    'ACS': (41, 9, 30),
    'solar power and battery': (26, 7, 11),
    'status, time, loop': (0, 0, 11),
}
# Result rates of one H100 SXM for those classes: 132 SMs at the 1.98 GHz
# boost clock behind the data sheet's fp32 rate (132 x 128 lanes x 2 flops
# x 1.98e9 = 67e12), 16 special-function and 64 ALU results per SM a clock
# (CUDA C++ Programming Guide, arithmetic instruction throughput, compute
# capability 9.0).
PEAK_MUFU_PER_S = 132 * 16 * 1.98e9
PEAK_ALU_PER_S = 132 * 64 * 1.98e9


def b1_ops_ms(substeps: float) -> dict:
  """Milliseconds each operation class needs for `substeps` substeps at
  its peak rate; the classes run on separate units, so the bound is the
  largest."""
  fp32, mufu, alu = (sum(c[i] for c in B1_SUBSTEP_OPS.values())
                     for i in range(3))
  return {'fp32': 1e3 * substeps * fp32 / PEAK_F32_FLOPS,
          'mufu': 1e3 * substeps * mufu / PEAK_MUFU_PER_S,
          'alu': 1e3 * substeps * alu / PEAK_ALU_PER_S}


def b1_inputs(params, state):
  """The fused kernel's packed inputs for `state` with random actions."""
  from ble_tpu_torch.env import balloon as balloon_lib
  from ble_tpu_torch.ops import physics
  g = torch.Generator().manual_seed(1)
  n = state.balloon.x_m.shape[0]
  action = torch.randint(0, 3, (n,), generator=g).to(DEV)
  b, act = balloon_lib.apply_safety(params.balloon, state.atmosphere,
                                    state.balloon, action)
  bufs = physics.pack(b, state.atmosphere, state.wind_u, state.wind_v, act)
  return b, act, bufs


def first_env_state(state, n: int):
  """The first n envs of an env state's balloon, atmosphere and winds:
  what B1 reads."""
  def head(obj):
    if dataclasses.is_dataclass(obj):
      return dataclasses.replace(obj, **{
          f.name: head(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    return obj[:n]
  return types.SimpleNamespace(balloon=head(state.balloon),
                               atmosphere=head(state.atmosphere),
                               wind_u=state.wind_u[:n], wind_v=state.wind_v[:n])


def b1_sensitivity(params, state, b, act, want) -> dict:
  """Per field, (E,): how far the plain version's 18 substeps from `b`
  move when every float input field moves one ulp up, or one ulp down
  (the larger)."""
  from ble_tpu_torch.env import balloon as balloon_lib
  sens = {}
  for to in (float('inf'), float('-inf')):
    nudged = dataclasses.replace(b, **{
        name: torch.nextafter(getattr(b, name),
                              torch.full_like(getattr(b, name), to))
        for name in balloon_lib.SUBSTEP_F32_FIELDS})
    out = balloon_lib.run_substeps(params.balloon, state.atmosphere, nudged,
                                   state.wind_u, state.wind_v, act, 18, 10)
    for name in balloon_lib.SUBSTEP_F32_FIELDS:
      d = (getattr(out, name) - getattr(want, name)).abs()
      sens[name] = d if name not in sens else torch.maximum(sens[name], d)
  return sens


def _b1_excess(params, got, want, sens) -> tuple:
  """Per field: the largest amount |got - want| exceeds B1's limit by
  (B1_ATOL + B1_RTOL |want| + B1_SENS_FACTOR x sens), and the envs over
  the fixed part alone."""
  from ble_tpu_torch.env import balloon as balloon_lib
  excess, over_fixed = {}, {}
  for name in balloon_lib.SUBSTEP_F32_FIELDS:
    w = getattr(want, name)
    diff = (getattr(got, name) - w).abs()
    fixed = B1_ATOL.get(name, 1e-2) + B1_RTOL * w.abs()
    excess[name] = float((diff - fixed - B1_SENS_FACTOR * sens[name]).max())
    over_fixed[name] = int((diff > fixed).sum())
  return excess, over_fixed


def check_b1(params, state) -> dict:
  """B1 against its plain version, 18 substeps from `state` with random
  actions: int fields and statuses equal, floats to B1_ATOL/B1_RTOL plus
  B1_SENS_FACTOR times the plain version's one-ulp response. At 4096 envs
  and more, the control (a payload mass B1_CONTROL_PAYLOAD times too
  large in the plain version) must break that limit."""
  from ble_tpu_torch.env import balloon as balloon_lib
  from ble_tpu_torch.ops import cuda_build
  from ble_tpu_torch.ops import physics
  b, act, bufs = b1_inputs(params, state)
  got = physics.substeps_kernel(params.balloon, state.atmosphere, b,
                                state.wind_u, state.wind_v, act, 18, 10)
  want = balloon_lib.run_substeps(params.balloon, state.atmosphere, b,
                                  state.wind_u, state.wind_v, act, 18, 10)
  sens = b1_sensitivity(params, state, b, act, want)
  torch.cuda.synchronize()
  errs = {}
  for name in balloon_lib.SUBSTEP_F32_FIELDS:
    g = getattr(got, name)
    check(bool(torch.isfinite(g).all()), f'B1 {name} not finite')
    errs[name] = float((g - getattr(want, name)).abs().max())
  for name in balloon_lib.SUBSTEP_I32_FIELDS:
    check(torch.equal(getattr(got, name), getattr(want, name)),
          f'B1 {name} differs')
  excess, over_fixed = _b1_excess(params, got, want, sens)
  log('B1 max |kernel - plain| by field:', json.dumps(errs))
  log('B1 largest one-ulp response of the plain version:',
      json.dumps({k: float(v.max()) for k, v in sens.items()}),
      '; envs past the fixed limit alone:',
      json.dumps({k: v for k, v in over_fixed.items() if v}))
  for name, over in excess.items():
    check(over <= 0, f'B1 {name} exceeds its tolerance by {over}')
  if b.x_m.shape[0] >= E:
    wrong = balloon_lib.run_substeps(
        dataclasses.replace(params.balloon,
                            payload_mass=params.balloon.payload_mass *
                            B1_CONTROL_PAYLOAD),
        state.atmosphere, b, state.wind_u, state.wind_v, act, 18, 10)
    c_excess, c_over = _b1_excess(params, wrong, want, sens)
    broken = {k: v for k, v in c_excess.items() if v > 0}
    log(f'B1 control (payload mass x {B1_CONTROL_PAYLOAD}): breaks the limit'
        f' by {json.dumps(broken)}; envs past the fixed limit alone '
        f'{json.dumps({k: v for k, v in c_over.items() if v})}')
    check(bool(broken), 'B1 control: a wrong payload mass passes the check')
  statuses = torch.bincount(got.status.long(), minlength=4).tolist()
  n = b.x_m.shape[0]
  log(f'B1 ok: E={n} G={physics.env_split(n, cuda_build.sm_count(0))}, 18 '
      f'substeps, statuses after {statuses}')
  return {'max_abs_err': errs['pressure_pa']}


def check_b1_split(params, state) -> dict:
  """B1 at E = 1, 7, 131 (one env a CTA) and 4096 (32 envs a CTA), the
  first envs of `state`. Returns the reading at 4096, the main path's."""
  for n in (1, 7, 131):
    check_b1(params, first_env_state(state, n))
  return check_b1(params, state)


def phase_numerics(params, state) -> None:
  """How far B1's kernel, its plain version on the card and its plain
  version on the CPU are from each other after 1 and 18 substeps on the
  same inputs: the max difference and the number of envs that differ."""
  from ble_tpu_torch.env import balloon as balloon_lib
  from ble_tpu_torch.ops import physics
  b, act, _ = b1_inputs(params, state)
  to_cpu = lambda obj: dataclasses.replace(obj, **{
      f.name: (to_cpu(getattr(obj, f.name))
               if dataclasses.is_dataclass(getattr(obj, f.name))
               else getattr(obj, f.name).cpu())
      for f in dataclasses.fields(obj)})
  for substeps in (1, 18):
    runs = {
        'kernel': physics.substeps_kernel(
            params.balloon, state.atmosphere, b, state.wind_u, state.wind_v,
            act, substeps, 10),
        'plain_card': balloon_lib.run_substeps(
            params.balloon, state.atmosphere, b, state.wind_u, state.wind_v,
            act, substeps, 10),
        'plain_cpu': balloon_lib.run_substeps(
            params.balloon, to_cpu(state.atmosphere), to_cpu(b),
            state.wind_u.cpu(), state.wind_v.cpu(), act.cpu(), substeps, 10),
    }
    for name in ('pressure_pa', 'superpressure_pa', 'envelope_volume_m3',
                 'ambient_temperature_k', 'internal_temperature_k'):
      vals = {k: getattr(v, name).cpu() for k, v in runs.items()}
      row = {}
      for a, c in (('kernel', 'plain_card'), ('plain_card', 'plain_cpu'),
                   ('kernel', 'plain_cpu')):
        diff = (vals[a] - vals[c]).abs()
        row[f'{a}-{c}'] = [float(diff.max()), int((diff > 0).sum())]
      log(f'numerics: {substeps} substeps, {name} [max, envs differing]:',
          json.dumps(row))


# ---------------------------------------------------------------- B2 ------


def gp_obs_seq(seed: int, k: int, n: int, t0_step: int = 0):
  """(K, n, 8) observations on drifting tracks (the harness of
  tests/test_pallas_gp_window.py:30-72), 180 s apart in even envs (so old
  points expire after 6 hours) and 60 s apart in odd envs (so the 128-slot
  ring evicts live points); every 4th env is disabled on odd steps."""
  rng = np.random.RandomState(seed)
  dt_s = np.where(np.arange(n) % 2, 60.0, 180.0)
  x = rng.normal(0, 50e3, n)
  y = rng.normal(0, 50e3, n)
  p = rng.uniform(6000, 13000, n)
  seq = np.zeros((k, n, 8), np.float32)
  for i in range(k):
    x = x + rng.normal(0, 2000.0, n)
    y = y + rng.normal(0, 2000.0, n)
    p = np.clip(p + rng.normal(0, 150.0, n), 5500, 13500)
    seq[i, :, 0], seq[i, :, 1], seq[i, :, 2] = x, y, p
    seq[i, :, 3] = dt_s * (t0_step + i + 1)
    seq[i, :, 4] = rng.normal(0, 1.0, n)
    seq[i, :, 5] = rng.normal(0, 1.0, n)
    seq[i, :, 6] = 1.0
    if (t0_step + i) % 2:
      seq[i, 3::4, 6] = 0.0
  return torch.from_numpy(seq).to(DEV)


def warmed_gp_state(seed: int = 0):
  """A GP state at E envs after 140 observations (past the 128-slot ring
  and the 6-hour expiry), built with the plain version."""
  from ble_tpu_torch.env import wind_gp
  from ble_tpu_torch.ops import gp_window
  state = wind_gp.init(E, DEV)
  obs = gp_obs_seq(seed, 140, E)
  for k0 in range(0, 140, 20):
    state, _ = gp_window.window_plain(state, obs[k0:k0 + 20])
    if k0 == 60:
      state = wind_gp.refresh(state)
  return state


# Float operations of one env's observe: M = kinv U, S = U^T M, the update
# vectors, the rank-8 update ((w_i c) w_j summed over 8 terms) and alpha.
OBSERVE_OPS = (2 * 128 * 128 * 4 + 2 * 16 * 128 + 128 * 30 +
               (2 * 8 + 1) * 128 * 128 + 2 * 2 * 128 * 128)


def query_ops(levels: int) -> float:
  """Float operations of one env's column query at `levels` pressures:
  the x/y/t distances, k* (8 a level and slot), means, v = k* kinv, the
  variance dot and the clip."""
  cap = 128
  return (cap * 10 + cap * levels * 8 + 2 * 2 * cap * levels +
          2 * cap * cap * levels + 2 * cap * levels + 4 * levels)


def observe_bytes(n: int) -> float:
  """Each input read once and each output written once: the state in and
  out, and the observation row."""
  state = 128 * 4 + 128 * 2 + 128 + 128 * 128 + 128 * 2 + 1
  return 4.0 * n * (2 * state + 8)


def query_bytes(n: int, levels: int) -> float:
  """The state the query reads, the (x, y, t) row, the pressures and the
  (n, levels, 3) output."""
  state = 128 * 4 + 128 + 128 * 128 + 128 * 2
  return 4.0 * (n * (state + 4 + levels * 3) + levels)


def b2_ops(obs_seq) -> float:
  """Float operations of the GP window for these inputs: every env and
  step runs the query; enabled steps also run the observe."""
  enabled = float((obs_seq[..., 6] > 0.5).sum())
  env_steps = obs_seq.shape[0] * obs_seq.shape[1]
  return enabled * OBSERVE_OPS + env_steps * query_ops(181)


def b2_bytes(obs_seq) -> float:
  cap, lv = 128, 181
  k, n = obs_seq.shape[0], obs_seq.shape[1]
  state = cap * 4 + cap * 2 + cap + cap * cap + cap * 2 + 1
  return 4.0 * n * (2 * state + k * 8 + k * lv * 3)


def b2_errs(got_state, got, want_state, want) -> dict:
  """Max |got - want| of kinv, alpha, means and deviations."""
  return {
      'kinv': float((got_state.kinv - want_state.kinv).abs().max()),
      'alpha': float((got_state.alpha - want_state.alpha).abs().max()),
      'means': float((got[..., :2] - want[..., :2]).abs().max()),
      'deviations': float((got[..., 2] - want[..., 2]).abs().max()),
  }


def check_b2(state, k: int, obs=None) -> dict:
  """The window kernel against its plain version from `state` (at its
  batch) over K steps of `obs` (by default gp_obs_seq's), each value held
  to B2_ATOL, or at K = 8 kinv and alpha to B2_K8_ATOL."""
  from ble_tpu_torch.ops import gp_window
  n = state.kinv.shape[0]
  if obs is None:
    obs = gp_obs_seq(1, k, n, t0_step=140)
  got_state, got = gp_window.window_kernel(state, obs)
  want_state, want = gp_window.window_plain(state, obs)
  torch.cuda.synchronize()
  check(tuple(got.shape) == (k, n, 181, 3), f'B2 level shape {got.shape}')
  check(bool(torch.isfinite(got).all()), 'B2 levels not finite')
  check(torch.equal(got_state.active, want_state.active), 'B2 active differs')
  check(torch.equal(got_state.count, want_state.count), 'B2 count differs')
  check(torch.equal(got_state.locations, want_state.locations),
        'B2 locations differ')
  check(torch.equal(got_state.errors, want_state.errors), 'B2 errors differ')
  errs = b2_errs(got_state, got, want_state, want)
  log(f'B2 E={n} K={k} max |kernel - plain|:', json.dumps(errs))
  for name, err in errs.items():
    limit = B2_K8_ATOL.get(name, B2_ATOL) if k == 8 else B2_ATOL
    check(err <= limit, f'B2 K={k} {name} error {err} > {limit}')
  return {'max_abs_err': max(errs.values())}


def phase_calibrate() -> None:
  """The readings behind B2_K8_ATOL. Over eight seeds of the warm-up and
  of the observations: the kernel's distance from the plain version at
  K = 8, beside the distances from it of two wrong versions: the plain
  version with TF32 matmuls (what the precision policy rules out), and
  the plain version without the -e_s e_s^T term of the rank-8 update.
  A wrong version whose state blows up past float32 reads inf."""
  from ble_tpu_torch.ops import gp_window
  core = gp_window._observe_core

  def dropped_term(*args):
    loc, act, kinv, sm, count = core(*args)
    return loc, act, kinv + sm * sm.transpose(1, 2), sm, count

  worst = {}
  for seed in range(8):
    state = warmed_gp_state(seed)
    obs = gp_obs_seq(100 + seed, 8, E, t0_step=140)
    runs = {}
    for k in (1, 8):
      want = gp_window.window_plain(state, obs[:k])
      if k == 8:
        runs['kernel K=8'] = (gp_window.window_kernel(state, obs), want)
      torch.backends.cuda.matmul.allow_tf32 = True
      try:
        runs[f'plain_tf32 K={k}'] = (
            gp_window.window_plain(state, obs[:k]), want)
      finally:
        torch.set_float32_matmul_precision('highest')
      gp_window._observe_core = dropped_term
      try:
        runs[f'plain_dropped_term K={k}'] = (
            gp_window.window_plain(state, obs[:k]), want)
      finally:
        gp_window._observe_core = core
    for name, (got, want) in runs.items():
      errs = {key: (err if np.isfinite(err) else float('inf'))
              for key, err in b2_errs(*got, *want).items()}
      log(f'calibrate: seed {seed} max |{name} - plain|:', json.dumps(errs))
      row = worst.setdefault(name, dict.fromkeys(errs, 0.0))
      for key, err in errs.items():
        row[key] = max(row[key], err)
  check(not torch.backends.cuda.matmul.allow_tf32, 'TF32 left on')
  log('calibrate: max over seeds:', json.dumps(worst))


# ------------------------------------------------------------ B3-B5 ------


# tests/test_pallas_gp_observe.py:119-122's tolerance for kinv and alpha of
# the observe kernel; tests/test_pallas_gp.py:100-103's for the column query
# on hardware.
B3_ATOL = 5e-3
B5_ATOL = {'means': 2e-4, 'deviations': 5e-5}


def gp_track_state(n: int, steps: int, seed: int = 0):
  """A GP state at n envs after `steps` observations of gp_obs_seq's
  tracks, built with the plain observe, and the next observation row."""
  from ble_tpu_torch.env import wind_gp
  from ble_tpu_torch.ops import gp_observe
  obs = gp_obs_seq(seed, steps + 1, n)
  state = wind_gp.init(n, DEV)
  for k in range(steps):
    state = gp_observe.observe_plain(state, obs[k])
  return state, obs[steps]


def check_b3_b4(state, obs, name: str) -> dict:
  """The observe kernel against its plain version from `state` on one
  observation row: slot bookkeeping exactly, kinv and alpha to B3_ATOL,
  and envs whose enabled flag is 0 exactly unchanged. B3 must take the
  cluster path (S > 1), B4 the one-CTA-per-env path."""
  from ble_tpu_torch.ops import cuda_build
  from ble_tpu_torch.ops import gp_observe
  split = gp_observe.observe_split(obs.shape[0], cuda_build.sm_count(0))
  check((split > 1) == (name == 'B3'), f'{name} took split {split}')
  got = gp_observe.observe_kernel(state, obs)
  want = gp_observe.observe_plain(state, obs)
  torch.cuda.synchronize()
  for field in ('active', 'count', 'locations', 'errors'):
    check(torch.equal(getattr(got, field), getattr(want, field)),
          f'{name} {field} differs')
  off = obs[:, 6] < 0.5
  for field in ('locations', 'errors', 'active', 'kinv', 'alpha', 'count'):
    check(torch.equal(getattr(got, field)[off], getattr(state, field)[off]),
          f'{name} disabled envs changed {field}')
  errs = {f: float((getattr(got, f) - getattr(want, f)).abs().max())
          for f in ('kinv', 'alpha')}
  log(f'{name} E={obs.shape[0]} S={split} ({int(off.sum())} disabled) max '
      f'|kernel - plain|:', json.dumps(errs))
  for f, err in errs.items():
    check(err <= B3_ATOL, f'{name} {f} error {err} > {B3_ATOL}')
  return {'max_abs_err': max(errs.values())}


def check_b3_drift() -> None:
  """tests/test_torch_gp_observe.py's 960-step churn-drift track through
  the observe kernel at E = 1, with and without an exact refresh every 64
  steps: the incremental posterior on a 181-level column against the exact
  inverse's, mean < 5e-2 m/s and deviation < 1e-3."""
  from ble_tpu_torch.env import wind_gp
  from ble_tpu_torch.ops import gp_observe
  from ble_tpu_torch.ops import gp_window
  for period in (0, wind_gp.REFRESH_PERIOD):
    rng = np.random.RandomState(3)
    state = wind_gp.init(1, DEV)
    x = y = 0.0
    p = 9000.0
    for i in range(960):
      if period and i % period == 0:
        state = wind_gp.refresh(state)
      x += rng.uniform(-800, 800)
      y += rng.uniform(-800, 800)
      p = np.clip(p + rng.uniform(-40, 40), 6000, 12000)
      eu, ev = rng.randn(2) * 2.0
      row = torch.tensor([[np.float32(x), np.float32(y), np.float32(p),
                           i * 180.0, eu, ev, 1.0, 0.0]], dtype=torch.float32)
      state = gp_observe.observe_kernel(state, row.to(DEV))
    levels = gp_window.pressure_levels(DEV)
    q = torch.stack([torch.full_like(levels, float(np.float32(x))),
                     torch.full_like(levels, float(np.float32(y))), levels,
                     torch.full_like(levels, 960 * 180.0)], dim=-1)[None]
    inc = wind_gp.query(state, q)
    ex = wind_gp.query(wind_gp.refresh(state), q)
    drift = [float((inc[0] - ex[0]).abs().max()),
             float((inc[1] - ex[1]).abs().max())]
    log(f'B3 960-step drift, refresh every {period or "never"}: mean '
        f'{drift[0]:.3g} m/s, deviation {drift[1]:.3g}')
    check(drift[0] < 5e-2 and drift[1] < 1e-3, f'B3 drift {drift}')


def check_b5(state, xs, ys, ts, name: str, n_levels: int = 181) -> dict:
  """The column-query kernel against its plain version at the 181 feature
  levels (or at n_levels pressures spread over the same span): means and
  deviations to B5_ATOL, shapes and finiteness."""
  from ble_tpu_torch.ops import cuda_build
  from ble_tpu_torch.ops import gp_query
  from ble_tpu_torch.ops import gp_window
  pres = (gp_window.pressure_levels(DEV) if n_levels == 181 else
          torch.linspace(5500.0, 13500.0, n_levels, device=DEV))
  args = gp_query.pack(state, xs, ys, ts, pres)
  got = gp_query.launch(*args)
  want = gp_query.query_plain(*args)
  torch.cuda.synchronize()
  n = xs.shape[0]
  check(tuple(got.shape) == (n, n_levels, 3), f'{name} shape {got.shape}')
  check(bool(torch.isfinite(got).all()), f'{name} not finite')
  errs = {'means': float((got[..., :2] - want[..., :2]).abs().max()),
          'deviations': float((got[..., 2] - want[..., 2]).abs().max())}
  slices = gp_query.level_split(n, n_levels, cuda_build.sm_count(0))
  log(f'{name} E={n} N={n_levels} S={slices} max |kernel - plain|:',
      json.dumps(errs))
  for f, err in errs.items():
    check(err <= B5_ATOL[f], f'{name} {f} error {err} > {B5_ATOL[f]}')
  return {'max_abs_err': max(errs.values())}


def first_envs(state, n: int):
  """The first n envs of a GP state."""
  return dataclasses.replace(state, **{
      f.name: getattr(state, f.name)[:n] for f in dataclasses.fields(state)})


def check_b5_split(gp_state, state1, obs1, obs) -> dict:
  """B5 at the edges of its level split: E = 1 (12 slices of 16 levels
  at N = 181), 7, 131 (2 slices) and 4096 (1 slice), each at N = 181 and
  the ragged N = 37; and on empty states, which must read exactly 0.
  Returns the readings of the gym (E = 1) and pair (E = 4096) shapes."""
  from ble_tpu_torch.env import wind_gp
  from ble_tpu_torch.ops import gp_query
  from ble_tpu_torch.ops import gp_window
  errs = {}
  for n in (1, 7, 131, E):
    if n == 1:
      st, ob = state1, obs1
    else:
      st, ob = first_envs(gp_state, n), obs[:n]
    for levels in (181, 37):
      err = check_b5(st, ob[:, 0], ob[:, 1], ob[:, 3], 'B5', levels)
      if levels == 181 and n in (1, E):
        errs['gp_query_gym' if n == 1 else 'gp_query_pair'] = err
  for n in (1, 7, 131, E):
    z = torch.zeros(n, device=DEV)
    out = gp_query.launch(*gp_query.pack(wind_gp.init(n, DEV), z, z, z,
                                         gp_window.pressure_levels(DEV)))
    check(int(torch.count_nonzero(out)) == 0, f'B5 empty state E={n} not 0')
  log('B5 empty states E=1, 7, 131, 4096: exactly 0')
  return errs


def check_b3_b4_b5(gp_state) -> dict:
  """B3 through the cluster path at E = 1, 2 and 7 (the last env disabled
  at E = 2 and 7, and env 3 at 7) and B4 through the per-env path at
  E = 4096 (odd step: every 4th env disabled), each from a state warmed
  past the ring and the expiry window; B5 at the edges of its level split;
  and B3's drift track."""
  state1, obs1 = gp_track_state(1, 140, seed=5)
  b3 = [check_b3_b4(state1, obs1, 'B3')['max_abs_err']]
  for n in (2, 7):
    st, ob = gp_track_state(n, 141, seed=5)
    ob = ob.clone()
    ob[n - 1, 6] = 0.0
    b3.append(check_b3_b4(st, ob, 'B3')['max_abs_err'])
  errs = {'gp_observe_b3': {'max_abs_err': max(b3)}}
  obs = gp_obs_seq(1, 2, E, t0_step=140)[1]
  errs['gp_observe_b4'] = check_b3_b4(gp_state, obs, 'B4')
  errs.update(check_b5_split(gp_state, state1, obs1, obs))
  check_b3_drift()
  return errs


# ------------------------------------------------------------ phases ------


def sass_mix(library: str) -> dict:
  """Static counts of float FMAs and shared loads (all, and 16-byte) in
  each kernel of a built library, from cuobjdump's SASS; {} without
  cuobjdump."""
  import re
  import shutil
  tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
  try:
    text = subprocess.run([tool, '-sass', library], check=True,
                          capture_output=True, text=True).stdout
  except (OSError, subprocess.CalledProcessError):
    return {}
  mix, name = {}, None
  for line in text.splitlines():
    m = re.search(r'Function : (\S+)', line)
    if m:
      name = m.group(1)
      mix[name] = {'FFMA': 0, 'LDS': 0, 'LDS.128': 0}
    elif name is not None:
      if re.search(r'\bFFMA\b', line):
        mix[name]['FFMA'] += 1
      if re.search(r'\bLDS(\.|\s)', line):
        mix[name]['LDS'] += 1
        if 'LDS.128' in line:
          mix[name]['LDS.128'] += 1
  return mix


def phase_build():
  """Builds every kernel and prints, for each, ptxas's registers, spills
  and static shared memory, the dynamic shared memory and resident CTAs a
  SM (from the GP libraries' info entries), and the static FMA/shared-load
  mix of its SASS."""
  import ctypes
  from ble_tpu_torch.ops import cuda_build
  t = time.perf_counter()
  seconds = cuda_build.build()
  log(f'build: {json.dumps({k: round(v, 2) for k, v in seconds.items()})} '
      f'({time.perf_counter() - t:.2f} s wall)')
  for name in cuda_build.SOURCES:
    with open(cuda_build.library_path(name) + '.log') as f:
      for line in f:
        if ('registers' in line or 'spill' in line or 'smem' in line or
            'Function properties' in line):
          log(f'  ptxas {name}: {line.strip()}')
    lib = cuda_build.load(name)
    info_fn = getattr(lib, f'ble_{name}_info', None)
    if info_fn is not None:
      info = (ctypes.c_int * 2)()
      info_fn.argtypes = [ctypes.c_void_p]
      cuda_build.check(info_fn(ctypes.addressof(info)), f'ble_{name}_info')
      log(f'  {name}: {info[0]} bytes of dynamic shared memory, {info[1]} '
          f'CTAs a SM')
    cluster_fn = getattr(lib, f'ble_{name}_cluster_info', None)
    if cluster_fn is not None:
      cluster_fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
      for split in (2, 4, 8):
        info = (ctypes.c_int * 3)()
        cuda_build.check(cluster_fn(split, ctypes.addressof(info)),
                         f'ble_{name}_cluster_info')
        log(f'  {name} cluster of {split}: {info[0]} bytes of dynamic '
            f'shared memory a CTA, {info[1]} CTAs a SM, {info[2]} clusters '
            f'resident at once')
    for kernel, mix in sass_mix(cuda_build.library_path(name)).items():
      log(f'  sass {name} {kernel}: {json.dumps(mix)}')


def phase_splits(params, state) -> None:
  """The designs the splits choose between, each timed by its device time
  (torch.profiler): B3 at E = 1 and 7 (warmed states) on one CTA an env and
  on clusters of 2, 4 and 8, with the CUDA-event time of back-to-back
  launches (the host's launch path at this size) and each one's max
  |kernel - plain| of kinv; B1 at E = 4096 with 8, 16 and 32 envs a CTA,
  whose outputs must be the same bits."""
  from ble_tpu_torch.ops import gp_observe
  from ble_tpu_torch.ops import physics
  f32 = lambda a: a.to(torch.float32).contiguous()
  for n in (1, 7):
    st, ob = gp_track_state(n, 140, seed=5)
    args = (ob, f32(st.locations), f32(st.errors), f32(st.active),
            f32(st.kinv), f32(st.alpha), st.count.to(torch.int32).contiguous())
    want = gp_observe.observe_plain(st, ob)
    row = {}
    for split in (1, 2, 4, 8):
      run = lambda: gp_observe.launch(*args, split=split)
      err = float((run()[3] - want.kinv).abs().max())
      row[f'S={split}'] = [kernel_device_ms(run), cuda_ms(run, reps=100),
                           err]
    log(f'splits: B3 E={n} [device ms, event ms, kinv error] by cluster '
        f'size:', json.dumps(row))
  _, _, bufs = b1_inputs(params, state)
  params_c = physics.uniform_params(params.balloon)
  row, first = {}, None
  for g in (8, 16, 32):
    outs = (torch.empty_like(bufs[0]), torch.empty_like(bufs[1]))
    run = lambda: physics.launch(*bufs, *outs, 18, 10, params_c,
                                 envs_per_cta=g)
    run()
    if first is None:
      first = outs
    check(torch.equal(outs[0], first[0]) and torch.equal(outs[1], first[1]),
          f'B1 with {g} envs a CTA differs')
    row[f'G={g}'] = kernel_device_ms(run)
  log(f'splits: B1 E={E} device ms by envs a CTA (same bits):',
      json.dumps(row))


def phase_tile() -> None:
  """The query engine's product loop alone (csrc/bench/product_tile.cu) in
  five forms, 4096 CTAs of 256 threads: the engine's 4 x 8 thread tile
  (three 16-byte shared loads a step for 32 FMAs), the same FMAs with one
  load and with none, an 8 x 8 tile on half the threads, and an 8 x 8 tile
  on all threads with the sum over a split between the half-warps. Prints the
  milliseconds of a launch with 1 and 3 passes over a 64-level chunk and
  the float32 rate of a pass (their difference drops the set-up)."""
  import ctypes
  import os
  from ble_tpu_torch.ops import cuda_build
  src = os.path.join(cuda_build.CSRC_DIR, 'bench', 'product_tile.cu')
  os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
  path = os.path.join(cuda_build.BUILD_DIR, 'libproduct_tile.so')
  subprocess.run([cuda_build._nvcc(), *cuda_build._COMMON_FLAGS, '-o', path,
                  src], check=True, capture_output=True)
  lib = ctypes.CDLL(path)
  lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p]
  lib.run.restype = ctypes.c_int
  ctas = 4096
  out = torch.empty(ctas * 256, device=DEV)
  stream = torch.cuda.current_stream().cuda_stream

  def launch(form, passes):
    cuda_build.check(lib.run(form, out.data_ptr(), ctas, passes, stream),
                     'product_tile')

  names = ('engine 4x8, 3 loads', '4x8, 1 load', '4x8, no load',
           '8x8 on half the threads', '8x8, sum over a split by half-warp')
  for form, name in enumerate(names):
    ms1 = cuda_ms(lambda: launch(form, 1), reps=20)
    ms3 = cuda_ms(lambda: launch(form, 3), reps=20)
    tflops = 2.0 * ctas * 64 * 128 * 128 / ((ms3 - ms1) / 2) / 1e9
    log(f'tile V{form} ({name}): {ms1:.4f} ms 1 pass, {ms3:.4f} ms 3 '
        f'passes, {tflops:.1f} TFLOP/s a pass')


def generative_field_fn():
  """One VAE-decoded grid per seed, from the loader's decoder (its
  deterministic fallback: no trained blob is in the repository)."""
  from ble_tpu_torch.env import env as env_lib
  from ble_tpu_torch.models import loader
  return env_lib.make_field_fn('generative',
                               loader.load_offlineskies22(device=DEV))


def static_field_fn():
  from ble_tpu_torch.env import env as env_lib
  return env_lib.make_field_fn('static')


def reset_main(params, field_fn):
  from ble_tpu_torch.env import env as env_lib
  t = time.perf_counter()
  state, obs = env_lib.reset(params, list(range(E)), field_fn, DEV)
  torch.cuda.synchronize()
  log(f'reset: E={E} on per-env generative fields in '
      f'{time.perf_counter() - t:.2f} s')
  check(tuple(state.wind.field.shape) == (E, 21, 21, 10, 9, 2),
        f'field shape {state.wind.field.shape}')
  check(bool(torch.isfinite(state.wind.field.float()).all()),
        'decoded fields not finite')
  return state, obs


def policy():
  from ble_tpu_torch.agents import station_seeker
  return (lambda keys, dev: (),
          lambda st, obs, draws: (st, station_seeker.pick_action(obs)))


def phase_reference():
  """8 envs, 32 steps: the card (kernels) against the CPU (plain).

  What a user reads must agree: time within radius and final timesteps
  exactly, the cumulative reward within the golden per-step reward bound
  (1e-3, tests/test_golden_trajectory.py:47) times the steps, and the
  flight path's position, elapsed time and state of charge within the
  golden trajectory's bounds (same file, lines 39-46). Balloon pressure
  and superpressure are printed, not bounded: near buoyant equilibrium
  they follow ulp-level differences of any two float32 evaluation orders
  (B1's plain version on the card and on the CPU differ by more than the
  kernel does from it; phase numerics).
  """
  from ble_tpu_torch.env import env as env_lib
  from ble_tpu_torch.train import eval_lib
  params = env_lib.EnvParams(field_cache=True)
  steps = 32
  out = {}
  for device in ('cuda', 'cpu'):
    fn = eval_lib.build_eval_fn(params, static_field_fn(),
                                *policy(), max_steps=steps,
                                record_flight_path=True, device=device)
    out[device] = {k: v.cpu() for k, v in fn(list(range(8))).items()}
  got, want = out['cuda'], out['cpu']
  fp_err = (got['flight_path'] - want['flight_path']).abs().amax(dim=(0, 1))
  log('reference: flight-path max |card - cpu| [x_km, y_km, pressure, '
      'superpressure, elapsed_s, soc]', fp_err.tolist())
  for col, name, limit in ((0, 'x_km', 0.05), (1, 'y_km', 0.05),
                           (4, 'elapsed_s', 0.0), (5, 'soc', 1e-3)):
    err = float(fp_err[col])
    check(err <= limit, f'reference flight-path {name} error {err} > {limit}')
  check(torch.equal(got['final_timestep'], want['final_timestep']),
        'reference final timesteps differ')
  check(torch.equal(got['time_within_radius'], want['time_within_radius']),
        'reference time within radius differs')
  rew_err = float((got['cumulative_reward'] -
                   want['cumulative_reward']).abs().max())
  check(rew_err <= steps * 1e-3, f'reference reward error {rew_err}')
  log(f'reference ok: cumulative reward error {rew_err:.3g}')


def port_worlds(fixture: dict, device) -> dict:
  """The port's values behind the JAX package's in `fixture` (the layout
  of tests/test_torch_worlds.py:jax_worlds), all but its StationSeeker
  eval: keys, initial conditions and latents drawn on the host, the
  fallback decoder's kernels in flax's (fan_in, fan_out) layout, the
  random agent's actions as the evaluator draws them, and
  parity_reset(0) on `device`."""
  import hashlib
  from ble_tpu_torch.agents import random_walk
  from ble_tpu_torch.env import env as env_lib
  from ble_tpu_torch.env import parity_reset
  from ble_tpu_torch.env import wind_field
  from ble_tpu_torch.generative import vae
  from ble_tpu_torch.models import loader
  from ble_tpu_torch.train import eval_lib
  from ble_tpu_torch.train import suites
  from ble_tpu_torch.utils import prng
  from ble_tpu_torch.utils import sampling
  ic_seeds = fixture['ic_seeds']
  keys = env_lib.seed_keys(ic_seeds)
  wide = fixture['wide']['seed']
  decoder = {}
  params = loader.fallback_decoder_params()
  for i in range(len(vae.Decoder().layers)):
    kernel = params[f'layers.{i}.weight'].t().double()
    decoder[f'Dense_{i}'] = {
        'shape': list(kernel.shape), 'sum': float(kernel.sum()),
        'sum_sq': float((kernel * kernel).sum()),
        'first': kernel.reshape(-1)[:16].tolist(),
        'bias_abs_sum': float(params[f'layers.{i}.bias'].abs().sum())}
  _, akey, base = eval_lib.policy_keys(WORLDS_SEEDS)
  draw = random_walk.random_policy(3).draw
  actions = torch.cat([draw(akey)[None], draw(eval_lib.step_keys(
      base, 0, WORLDS_ACTION_STEPS - 1))])
  state, _ = parity_reset.parity_reset(0, env_lib.EnvParams(),
                                       field_fn=env_lib.make_field_fn(
                                           'static'), device=device)
  perms = state.wind.noise_perms[0].cpu().to(torch.int32).contiguous()
  strata = suites._strata_seeds()
  ic = sampling.sample_initial_conditions(keys)
  ic['noise_seeds'], ic['noise_offsets'] = wind_field.reset_noise(
      ic.pop('noise_keys'))
  return {
      'ic_seeds': ic_seeds,
      'strata_first': {name: seeds[0] for name, seeds in strata.items()},
      'reset_keys': keys.tolist(),
      'initial_conditions': {k: v.tolist() for k, v in ic.items()},
      'wide': {'seed': wide, 'key': prng.key(wide).tolist(),
               'reset_key': env_lib.seed_keys([wide])[0].tolist()},
      'latents': vae.sample_latent(
          env_lib.forecast_keys(keys[:4])).tolist(),
      'decoder': decoder,
      'random_actions': actions.t().tolist(),
      'parity_reset_0': {
          'noise_seeds': state.wind.noise_seeds[0].tolist(),
          'noise_offsets': state.wind.noise_offsets[0].tolist(),
          'perms_sha256': hashlib.sha256(perms.numpy().tobytes()).hexdigest()},
  }


def compare_worlds(got: dict, want: dict) -> list:
  """Where the port's worlds depart from the JAX package's, as messages
  (an empty list when they agree). Integers, keys, hashes and uniforms are
  exact; initial conditions from normals, beta draws and float32 math
  within 1e-5 relative (1e-6 absolute near 0); latents within 1e-6
  relative (a few ulp); the decoder's values and sums of squares within
  1e-6 relative, its sums within 1e-6 x sqrt(n x sum of squares), what
  1e-6 relative on every value allows; the StationSeeker eval, when
  `got` has it, with time within radius and final timesteps equal and
  rewards within WORLDS_STEPS x 1e-3 (phase reference's bound)."""
  bad = []

  def close(name, a, b, rtol, atol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
      bad.append(f'{name}: shape {a.shape} != {b.shape}')
    elif not np.all(np.abs(a - b) <= atol + rtol * np.abs(b)):
      bad.append(f'{name}: max error {np.abs(a - b).max():.3g}')

  def equal(name, a, b):
    if a != b:
      bad.append(f'{name}: {a} != {b}')

  for name in ('ic_seeds', 'strata_first', 'reset_keys', 'wide',
               'random_actions'):
    equal(name, got[name], want[name])
  for name, b in want['initial_conditions'].items():
    a = got['initial_conditions'][name]
    if name in ('time_s', 'noise_seeds', 'atmosphere_alpha',
                'noise_offsets'):
      equal(f'initial_conditions.{name}', a, b)
    else:
      close(f'initial_conditions.{name}', a, b, 1e-5, 1e-6)
  close('latents', got['latents'], want['latents'], 1e-6, 1e-7)
  for name, b in want['decoder'].items():
    a = got['decoder'][name]
    equal(f'decoder.{name}.shape', a['shape'], b['shape'])
    equal(f'decoder.{name}.bias_abs_sum', a['bias_abs_sum'],
          b['bias_abs_sum'])
    close(f'decoder.{name}.first', a['first'], b['first'], 1e-6, 0.0)
    close(f'decoder.{name}.sum_sq', a['sum_sq'], b['sum_sq'], 1e-6, 0.0)
    n = b['shape'][0] * b['shape'][1]
    close(f'decoder.{name}.sum', a['sum'], b['sum'], 0.0,
          1e-6 * np.sqrt(n * b['sum_sq']))
  for name in ('noise_seeds', 'noise_offsets', 'perms_sha256'):
    equal(f'parity_reset_0.{name}', got['parity_reset_0'][name],
          want['parity_reset_0'][name])
  if 'station_seeker' in got:
    a, b = got['station_seeker'], want['station_seeker']
    equal('station_seeker.final_timestep', a['final_timestep'],
          b['final_timestep'])
    equal('station_seeker.time_within_radius', a['time_within_radius'],
          b['time_within_radius'])
    close('station_seeker.cumulative_reward', a['cumulative_reward'],
          b['cumulative_reward'], 0.0, WORLDS_STEPS * 1e-3)
  return bad


def _eval_results(fn, seeds) -> dict:
  return {k: v.cpu() for k, v in fn(seeds).items()}


def phase_worlds(field_fn) -> None:
  """Seed-to-world parity on the card (see the module docstring)."""
  import os
  from ble_tpu_torch.env import env as env_lib
  from ble_tpu_torch.env import parity_reset
  from ble_tpu_torch.env import wind_field
  from ble_tpu_torch.generative import vae
  from ble_tpu_torch.train import eval as eval_cli
  from ble_tpu_torch.train import eval_lib
  from ble_tpu_torch.utils import prng
  from ble_tpu_torch.utils import sampling
  with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         WORLDS_FIXTURE)) as f:
    fixture = json.load(f)
  got = port_worlds(fixture, DEV)

  # The JAX package's fixture eval: default EnvParams (bf16 grid, no
  # slab cache), each seed on its own decoded field.
  run = eval_lib.build_eval_fn(env_lib.EnvParams(), field_fn, *policy(),
                               max_steps=WORLDS_STEPS, device=DEV)
  counts = _reset_counts()
  result = run(WORLDS_SEEDS)
  torch.cuda.synchronize()
  launches = counts()
  got['station_seeker'] = {
      'cumulative_reward': result['cumulative_reward'].tolist(),
      'time_within_radius': result['time_within_radius'].tolist(),
      'final_timestep': result['final_timestep'].tolist()}
  log(f'worlds: StationSeeker eval, {len(WORLDS_SEEDS)} seeds x '
      f'{WORLDS_STEPS} steps, launches {json.dumps(launches)}; rewards '
      f'{got["station_seeker"]["cumulative_reward"]} against JAX '
      f'{fixture["station_seeker"]["cumulative_reward"]}')
  # B2 also serves the reset's first observation.
  check(launches['physics'] == WORLDS_STEPS and
        launches['gp_window'] == WORLDS_STEPS + 1,
        f'worlds: B1 and B2 not launched once a step: {launches}')
  bad = compare_worlds(got, fixture)
  log(f'worlds: against the JAX package\'s values: '
      f'{"all agree" if not bad else bad}')
  check(not bad, f'worlds: the port departs from the JAX package: {bad}')

  # Fault C: a random_walk seed's result whatever its batch or shard.
  static = static_field_fn()
  init, step, draw = eval_cli.make_policy_fns('random_walk', device=DEV)
  rw = eval_lib.build_eval_fn(env_lib.EnvParams(), static, init, step,
                              max_steps=32, device=DEV, policy_draw=draw)
  alone = _eval_results(rw, [1])
  pair = _eval_results(rw, [0, 1])
  shard = _eval_results(rw, [0, 1, 2, 3][1::2])
  same = {k: torch.equal(alone[k][0], pair[k][1]) and
          torch.equal(alone[k][0], shard[k][0]) for k in alone}
  log(f'worlds: random_walk seed 1 alone, in [0, 1] and in shard 1 of 2, '
      f'equal in bits: {json.dumps(same)}; cumulative reward '
      f'{float(alone["cumulative_reward"][0])}')
  check(all(same.values()), f'worlds: seed 1 depends on its batch: {same}')

  # Parity mode, one env, card against CPU, on one action sequence.
  actions = prng.randint(prng.split(prng.key(5), WORLDS_PARITY_STEPS), (),
                         0, 3)
  runs = {}
  for device in (DEV, 'cpu'):
    params = env_lib.EnvParams(wind_field_f32=True)
    state, obs = parity_reset.parity_reset(0, params, field_fn=static,
                                           device=device)
    rows = []
    for a in actions:
      out = env_lib.step_batched(params, state, a[None].to(device))
      b = out.state.balloon
      rows.append(torch.stack([out.reward, b.x_m / 1000.0, b.y_m / 1000.0,
                               out.state.wind_u, out.state.wind_v]).cpu())
      state = out.state
    runs[device] = torch.stack(rows)[..., 0]
  err = (runs[DEV] - runs['cpu']).abs().amax(dim=0).tolist()
  log(f'worlds: parity mode, {WORLDS_PARITY_STEPS} steps of one env, max '
      f'|card - cpu| [reward, x_km, y_km, wind_u, wind_v] {err}')
  check(err[0] <= 1e-3 and err[1] <= 0.05 and err[2] <= 0.05,
        f'worlds: parity mode card and CPU apart: {err}')

  # Times: the host draws of a 4096-seed reset, the whole reset on the
  # card, and the fallback decoder's init.
  seeds = list(range(WORLDS_RESET_E))
  t = time.perf_counter()
  ic = sampling.sample_initial_conditions(env_lib.seed_keys(seeds))
  wind_field.reset_noise(ic['noise_keys'])
  draws_ms = (time.perf_counter() - t) * 1e3
  params = env_lib.EnvParams(field_cache=True)
  reset_ms = []
  for _ in range(2):
    t = time.perf_counter()
    env_lib.reset(params, seeds, field_fn, DEV)
    torch.cuda.synchronize()
    reset_ms.append((time.perf_counter() - t) * 1e3)
  t = time.perf_counter()
  vae.init_decoder_params(prng.key(0))
  init_s = time.perf_counter() - t
  log(f'worlds: {WORLDS_RESET_E}-seed reset: host draws {draws_ms:.1f} ms, '
      f'whole reset {reset_ms[0]:.1f} ms then {reset_ms[1]:.1f} ms; '
      f'fallback decoder init {init_s:.2f} s; {nvidia_smi_line()}')


def _reset_counts():
  from ble_tpu_torch.ops import gp_observe
  from ble_tpu_torch.ops import gp_query
  from ble_tpu_torch.ops import gp_window
  from ble_tpu_torch.ops import physics
  counters = {'physics': physics.launch, 'gp_window': gp_window.launch,
              'gp_observe': gp_observe.launch, 'gp_query': gp_query.launch}
  for launcher in counters.values():
    launcher.launches = 0
  return lambda: {k: v.launches for k, v in counters.items()}


def device_time(fn, steps: int):
  """torch.profiler over fn() (which runs `steps` steps and synchronises):
  (device kernel ms per step, kernel launches per step, the profile)."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    fn()
  events = prof.key_averages()
  kernels = [e for e in events
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
  device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
  return device_ms, sum(e.count for e in kernels) / steps, events


GYM_STEPS = 128
GYM_CHECK_STEPS = 16


def phase_gym() -> dict:
  """This slice's path: BalloonEnv(wind_field='generative') on the card,
  the user's single-env entry, for GYM_STEPS StationSeeker steps through
  env.step; B1, B3 and B5 must each launch once a step. Its first
  GYM_CHECK_STEPS steps against the same env on the CPU (plain versions),
  driven with the card's actions: x and y within 0.05 km, elapsed time
  exactly, state of charge within 1e-3 (the golden trajectory's bounds,
  tests/test_golden_trajectory.py:39-46). Then the step's wall time, and
  its device time and busy share under torch.profiler over 4 more steps.
  The StationSeeker agent, and the random and random-walk agents that
  act once on the last observation, are built as a user builds them,
  through agents.base.create_agent with no device: on the card.
  Returns the launches of the path's kernels and the env's state, at which
  phase timing times B1 and B5 at E = 1."""
  from ble_tpu_torch.agents import base
  from ble_tpu_torch.env import gym_env
  env = gym_env.BalloonEnv(wind_field='generative', seed=7, device=DEV)
  obs, info = env.reset(seed=7)
  check(obs.shape == (1099,) and info == {}, 'gym reset output')
  agent = base.create_agent('station_seeker', num_actions=3,
                            observation_shape=(1099,))
  check(agent._device.type == 'cuda', 'StationSeekerAgent not on the card')
  actions, infos = [], []
  counts = _reset_counts()
  t = time.perf_counter()
  action = agent.begin_episode(obs)
  for _ in range(GYM_STEPS):
    obs, reward, terminated, truncated, info = env.step(action)
    check(obs.shape == (1099,) and bool(np.isfinite(obs).all()),
          'gym observation not finite')
    check(0.0 <= reward <= 1.0 and truncated is False, 'gym step output')
    actions.append(action)
    infos.append(info)
    action = agent.step(reward, obs)
  torch.cuda.synchronize()
  wall_ms = 1e3 * (time.perf_counter() - t) / GYM_STEPS
  launches = counts()
  for name in ('random', 'random_walk'):
    other = base.create_agent(name, num_actions=3, observation_shape=(1099,),
                              seed=0)
    check(other._device.type == 'cuda' and
          other.begin_episode(obs) in (0, 1, 2) and
          other.step(0.0, obs) in (0, 1, 2), f'gym: agent {name} on the card')
  log(f'gym: {GYM_STEPS} steps, launches {json.dumps(launches)}, '
      f'{wall_ms:.2f} ms a step, terminated {terminated}')
  for name in ('physics', 'gp_observe', 'gp_query'):
    check(launches[name] == GYM_STEPS,
          f'gym: {name} launched {launches[name]} times in {GYM_STEPS} steps')
  check(launches['gp_window'] == 0, 'gym: the fused GP kernel ran')

  cpu = gym_env.BalloonEnv(wind_field='generative', seed=7, device='cpu')
  cpu.reset(seed=7)
  worst = dict.fromkeys(('x_km', 'y_km', 'time_elapsed_s', 'battery_soc'),
                        0.0)
  for action, got in zip(actions[:GYM_CHECK_STEPS], infos):
    want = cpu.step(action)[4]
    for key in worst:
      worst[key] = max(worst[key], abs(got[key] - want[key]))
  log(f'gym: first {GYM_CHECK_STEPS} steps, max |card - cpu|:',
      json.dumps(worst))
  for key, limit in (('x_km', 0.05), ('y_km', 0.05), ('time_elapsed_s', 0),
                     ('battery_soc', 1e-3)):
    check(worst[key] <= limit, f'gym {key} error {worst[key]} > {limit}')

  def more_steps(n=16):
    for _ in range(n):
      env.step(1)
    torch.cuda.synchronize()

  more_steps()
  t = time.perf_counter()
  more_steps()
  steady_ms = 1e3 * (time.perf_counter() - t) / 16
  # 4 profiled steps: 16 took ~42 s under the profiler.
  device_ms, per_step, _ = device_time(lambda: more_steps(4), 4)
  summary = {'wall_ms_per_step': wall_ms, 'steady_wall_ms_per_step': steady_ms,
             'device_ms_per_step': device_ms,
             'device_launches_per_step': per_step,
             'device_busy_share': device_ms / steady_ms}
  log('gym:', json.dumps(summary))
  check_gym_renderer()
  return {'physics_gym': launches['physics'],
          'gp_observe_b3': launches['gp_observe'],
          'gp_query_gym': launches['gp_query']}, env.get_simulator_state()


GYM_RENDER_STEPS = 16


def check_gym_renderer() -> None:
  """BalloonEnv(wind_field='generative') on the card with a
  MatplotlibRenderer for GYM_RENDER_STEPS steps (the actions cycle down,
  stay, up): the renderer's points after the reset and each step equal
  the env's balloon state read out then, x and y in km, pressure, and the
  charge over the battery's capacity."""
  from ble_tpu_torch.env import balloon as balloon_lib
  from ble_tpu_torch.env import gym_env
  from ble_tpu_torch.env.rendering import renderer as renderer_lib
  renderer = renderer_lib.MatplotlibRenderer()
  env = gym_env.BalloonEnv(wind_field='generative', seed=11, device=DEV,
                           renderer=renderer)
  check(env.metadata == {'render.modes': renderer.render_modes},
        'gym renderer: metadata')
  env.reset(seed=11)
  want = []

  def read_out():
    b = env.get_balloon_state()
    check(b.x_m.device.type == 'cuda', 'gym renderer: env not on the card')
    x, y, p, charge = (float(v[0]) for v in (b.x_m, b.y_m, b.pressure_pa,
                                             b.battery_charge_j))
    want.append((x / 1000.0, y / 1000.0, p,
                 charge / balloon_lib.BalloonParams.battery_capacity_j))

  read_out()
  for i in range(GYM_RENDER_STEPS):
    env.step(i % 3)
    read_out()
  got = list(zip(renderer._xs, renderer._ys, renderer._pressures,
                 renderer._socs))
  check(got == want, f'gym renderer: track {got[:2]} vs states {want[:2]}')
  log(f'gym: renderer recorded {len(got)} points on the card, equal to the '
      f'states; last (x km, y km, Pa, soc) {got[-1]}')


PAIR_STEPS = 8


def phase_pair(field_fn) -> dict:
  """The two step routes from the same state: env.step (B1, B4, B5) and
  step_batched (B1, B2), E = 4096 envs on per-env generative fields,
  PAIR_STEPS StationSeeker steps along env.step's trajectory with the slab
  re-centred before each. Observations within 5e-3 (B2's tolerance, as the
  two routes differ in GP summation order and in the GP error: truth -
  forecast against the noise itself), rewards equal (same physics)."""
  from ble_tpu_torch.agents import station_seeker
  from ble_tpu_torch.env import env as env_lib
  params = env_lib.EnvParams(field_cache=True)
  state, obs = env_lib.reset(params, list(range(E)), field_fn, DEV)
  counts = _reset_counts()
  worst = 0.0
  for _ in range(PAIR_STEPS):
    state = env_lib.refresh_field_cache(state)
    action = station_seeker.pick_action(obs)
    out = env_lib.step(params, state, action, refresh='never')
    ref = env_lib.step_batched(params, state, action, refresh='never')
    check(bool(torch.isfinite(out.observation).all()), 'pair obs not finite')
    check(torch.equal(out.reward, ref.reward), 'pair rewards differ')
    worst = max(worst, float((out.observation - ref.observation).abs().max()))
    state, obs = out.state, out.observation
  torch.cuda.synchronize()
  launches = counts()
  log(f'pair: E={E}, {PAIR_STEPS} steps, launches {json.dumps(launches)}, '
      f'max |env.step obs - step_batched obs| {worst:.3g}')
  check(worst <= 5e-3, f'pair observation error {worst} > 5e-3')
  for name, want in (('physics', 2 * PAIR_STEPS), ('gp_observe', PAIR_STEPS),
                     ('gp_query', PAIR_STEPS), ('gp_window', PAIR_STEPS)):
    check(launches[name] == want, f'pair: {name} launched {launches[name]}')
  return {'gp_observe_b4': launches['gp_observe'],
          'gp_query_pair': launches['gp_query']}


def phase_main(params, field_fn, state0, obs0) -> dict:
  from ble_tpu_torch.train import eval_lib
  run = eval_lib.build_eval_fn(params, field_fn, *policy(),
                               max_steps=MAIN_STEPS,
                               from_states=True, device=DEV)
  seeds = list(range(E))
  counts = _reset_counts()
  t = time.perf_counter()
  result = run(seeds, state0, obs0)
  torch.cuda.synchronize()
  first_s = time.perf_counter() - t
  launches = counts()
  log(f'main: launches {json.dumps(launches)}')
  check(launches['physics'] >= MAIN_STEPS, 'B1 was not launched per step')
  check(launches['gp_window'] >= MAIN_STEPS, 'B2 was not launched per step')
  launches = {k: launches[k] for k in ('physics', 'gp_window')}
  twr = result['time_within_radius']
  check(tuple(twr.shape) == (E,), f'twr shape {twr.shape}')
  check(bool(((twr >= 0) & (twr <= 1)).all()), 'twr outside [0, 1]')
  check(bool(torch.isfinite(result['cumulative_reward']).all()),
        'rewards not finite')
  check(bool(torch.isfinite(obs0).all()), 'initial observations not finite')

  # Second run from the same initial state, with the observations checked
  # at every step.
  checks = []

  def policy_step(st, obs, draws):
    checks.append(torch.isfinite(obs).all())
    return policy()[1](st, obs, draws)

  run2 = eval_lib.build_eval_fn(params, field_fn, lambda keys, dev: (),
                                policy_step,
                                max_steps=MAIN_STEPS, from_states=True,
                                device=DEV)
  t = time.perf_counter()
  result2 = run2(seeds, state0, obs0)
  torch.cuda.synchronize()
  second_s = time.perf_counter() - t
  check(bool(torch.stack(checks).all()), 'observations not finite')
  check(torch.equal(result2['final_timestep'], result['final_timestep']),
        'the two main-path runs differ')
  summary = {
      'envs': E, 'steps': MAIN_STEPS,
      'mean_twr': float(twr.mean()),
      'mean_cumulative_reward': float(result['cumulative_reward'].mean()),
      'terminated': int((result['final_timestep'] < MAIN_STEPS).sum()),
      'first_run_s': first_s, 'second_run_s': second_s,
      'env_steps_per_s': E * MAIN_STEPS / second_s,
  }
  log('main:', json.dumps(summary))
  return {'launches': launches, 'summary': summary,
          'per_step_ms': 1e3 * second_s / MAIN_STEPS}


# Phase api (b): the training CLI with its periodic eval, QR-DQN at
# TrainConfig's defaults, two iterations of 8 env steps, an eval after
# each over micro_eval (one seed, 960 steps). The JAX package's record keys
# (ble_tpu/train/train.py:50-57 and its eval_lib.summarize), which
# tests/test_torch_periodic_eval.py reads from the JAX package itself.
API_CLI_ARGS = ('--agent', 'quantile', '--num_iterations', '2',
                '--max_episode_length', '8', '--eval_every', '1',
                '--eval_suite', 'micro_eval')
API_RECORD_KEYS = {'iteration', 'env_steps', 'train_steps', 'wall_s',
                   'mean_cumulative_reward', 'mean_twr', 'num_terminated',
                   'num_seeds'}


@contextlib.contextmanager
def _recorded_query_columns(seen: list):
  """Notes each wind_gp.query_column result (error means, deviations)."""
  from ble_tpu_torch.env import wind_gp
  query = wind_gp.query_column

  def noted(*args, **kwargs):
    out = query(*args, **kwargs)
    seen.append(out)
    return out

  wind_gp.query_column = noted
  try:
    yield
  finally:
    wind_gp.query_column = query


def api_column_features(params, state) -> dict:
  """(a) features.wind_column_features at the main path's E = 4096 on its
  reset state (generative fields, slab cache on): B5 launched once by it,
  its output equal in bits to get_features' column block on the same
  state, and its GP column query (the kernel's output) within B5_ATOL of
  the same call on the CPU, where the plain version runs; then its time
  by CUDA events."""
  from ble_tpu_torch.env import env as env_lib
  from ble_tpu_torch.env import features
  b = state.balloon
  args = (params.balloon, b, state.gp, state.wind, state.atmosphere)
  seen = []
  counts = _reset_counts()
  with _recorded_query_columns(seen):
    column = features.wind_column_features(*args)
  torch.cuda.synchronize()
  launches = counts()
  check(launches['gp_query'] == 1 and len(seen) == 1,
        f'api: wind_column_features launched {launches}')
  check(tuple(column.shape) == (E, 361, 3) and
        column.device.type == torch.device(DEV).type,
        f'api: wind_column_features shape {tuple(column.shape)}')
  check(bool(torch.isfinite(column).all()), 'api: column features not finite')
  full = features.get_features(*args, state.sunrise_s, state.sunset_s)
  check(torch.equal(full[:, 16:], column.reshape(E, -1)),
        'api: wind_column_features differs from the column block of '
        'get_features')

  to_cpu = lambda x: x.cpu()
  cpu_args = (params.balloon,) + tuple(env_lib.tree_map(to_cpu, a)
                                       for a in args[1:])
  cpu_seen = []
  with _recorded_query_columns(cpu_seen):
    cpu_column = features.wind_column_features(*cpu_args)
  errs = {'means': float((seen[0][0].cpu() - cpu_seen[0][0]).abs().max()),
          'deviations': float((seen[0][1].cpu() - cpu_seen[0][1])
                              .abs().max())}
  feature_err = float((column.cpu() - cpu_column).abs().max())
  ms = cuda_ms(lambda: features.wind_column_features(*args), reps=10)
  log(f'api: wind_column_features E={E}: B5 launches {launches["gp_query"]}, '
      f'equal to get_features\' column block; max |card - cpu| of its GP '
      f'query {json.dumps(errs)}, of the features {feature_err:.3g} (not '
      f'gated: reachability masks from another float32 evaluation order); '
      f'{ms:.4f} ms a call by CUDA events; {nvidia_smi_line()}')
  for f, err in errs.items():
    check(err <= B5_ATOL[f], f'api: B5 {f} card vs CPU {err} > {B5_ATOL[f]}')
  return {'launches': launches['gp_query'],
          'max_abs_err': max(errs.values()), 'ms': ms}


def api_train_cli() -> dict:
  """(b) `python -m ble_tpu_torch.train.train` with --eval_every 1 as a user
  runs it (API_CLI_ARGS, no --device, so on the card, at TrainConfig's
  full width over 1024 generative envs): two learning_curve.jsonl records
  with the JAX package's keys, B1 and B2 launched through each eval's 960
  steps, and the last record's TWR and reward equal to a re-evaluation of
  the final checkpoint's network: the eval CLI (`python -m
  ble_tpu_torch.train.eval --agent quantile --checkpoint_dir`, that is
  eval_lib.evaluate over learner.make_eval_policy of the checkpoint's
  network, on the card at the same batch of one seed). It starts as soon
  as the training loop has written the last checkpoint (before the last
  eval, ble_tpu_torch/train/train_lib.py:run_training_loop) and runs
  beside that eval, so the eval's rate is read from the first one."""
  import os
  import tempfile
  from ble_tpu_torch.train import eval_lib
  from ble_tpu_torch.train import suites
  from ble_tpu_torch.train import train
  evals, started = [], []
  make = train.make_periodic_eval
  last = int(API_CLI_ARGS[API_CLI_ARGS.index('--num_iterations') + 1]) - 1
  suite = suites.get_eval_suite('micro_eval')
  steps = suite.max_episode_length * len(suite.seeds)
  with tempfile.TemporaryDirectory() as d:
    eval_dir = os.path.join(d, 'eval')

    def timed(*args, **kwargs):
      callback = make(*args, **kwargs)

      def eval_cb(ts, iteration):
        if iteration == last:
          started.append(time.perf_counter())
          started.append(_start([
              sys.executable, '-m', 'ble_tpu_torch.train.eval', '--agent',
              'quantile', '--checkpoint_dir', d, '--suite', 'micro_eval',
              '--output_dir', eval_dir]))
        counts = _reset_counts()
        t = time.perf_counter()
        callback(ts, iteration)
        torch.cuda.synchronize()
        evals.append({'seconds': time.perf_counter() - t, **counts()})

      return eval_cb

    train.make_periodic_eval = timed
    try:
      t = time.perf_counter()
      ts = train.main(['--base_dir', d, *API_CLI_ARGS])
      torch.cuda.synchronize()
      run_s = time.perf_counter() - t
    except BaseException:
      _stop(started[1:])
      raise
    finally:
      train.make_periodic_eval = make
    check(len(started) == 2, 'api: the last iteration was not evaluated')
    _finish(started[1:])
    reeval_s = time.perf_counter() - started[0]
    with open(os.path.join(d, 'learning_curve.jsonl')) as f:
      records = [json.loads(line) for line in f]
    with open(os.path.join(eval_dir, 'quantile_micro_eval.json')) as f:
      results = json.load(f)['results']
  want = eval_lib.summarize([eval_lib.EvaluationResult(**r) for r in results])
  log(f'api: train CLI {" ".join(API_CLI_ARGS)}: {run_s:.2f} s, evals '
      f'{json.dumps(evals)}; records {json.dumps(records)}; the eval CLI on '
      f'the last checkpoint {json.dumps(want)}, done {reeval_s:.2f} s after '
      f'its start; eval {steps / evals[0]["seconds"]:.1f} env-steps/s at '
      f'E = {len(suite.seeds)}; {nvidia_smi_line()}')
  check([r['iteration'] for r in records] == [0, last],
        f'api: learning_curve iterations {[r.get("iteration") for r in records]}')
  for r in records:
    check(set(r) == API_RECORD_KEYS, f'api: record keys {sorted(r)}')
  check(records[-1]['env_steps'] == ts.env_steps * ts.obs.shape[0] and
        records[-1]['train_steps'] == ts.learner.train_steps,
        f'api: last record counts {records[-1]}')
  check([r['seed'] for r in results] == list(suite.seeds),
        f'api: eval CLI seeds {[r["seed"] for r in results]}')
  for key in ('mean_twr', 'mean_cumulative_reward', 'num_terminated',
              'num_seeds'):
    check(records[-1][key] == want[key],
          f'api: record {key} {records[-1][key]} != re-evaluation {want[key]}')
  for e in evals:
    check(e['physics'] >= steps and e['gp_window'] >= steps,
          f'api: B1 or B2 not launched every eval step: {e}')
  return {'launches': {k: sum(e[k] for e in evals)
                       for k in ('physics', 'gp_window')},
          'eval_steps_per_s': steps / evals[0]['seconds'],
          'run_s': run_s, 'reeval_s': reeval_s}


def phase_api(params, state) -> dict:
  """(a) wind_column_features on the main path's state, (b) the training
  CLI's periodic eval (see the module docstring)."""
  t = time.perf_counter()
  column = api_column_features(params, state)
  cli = api_train_cli()
  log(f'api: phase {time.perf_counter() - t:.1f} s')
  return {'column': column, 'cli': cli}


# Phase params: step_batched's own slab cadence (global_step with
# field_cache_every = PARAMS_CACHE_EVERY) on the main path's reset state
# for PARAMS_STEPS steps.
PARAMS_STEPS = 16
PARAMS_CACHE_EVERY = 4


def _same_step(a, b) -> bool:
  return (torch.equal(a.observation, b.observation) and
          torch.equal(a.reward, b.reward) and torch.equal(a.done, b.done) and
          set(a.info) == set(b.info) and
          all(torch.equal(a.info[k], b.info[k]) for k in a.info))


def phase_params(params, state) -> dict:
  """PARAMS_STEPS steps of step_batched with global_step=t and
  field_cache_every = PARAMS_CACHE_EVERY from the main path's reset state
  (E = 4096 generative envs, slab cache on), every count set to 0 just
  before and read just after: B1 and B2 once a step, B3-B5 never, no
  balloon outside its slab. The same steps with refresh='never' and a
  re-centre by hand every PARAMS_CACHE_EVERY steps must give the same bits
  (each step's outputs and the final state). Returns the launches, the
  final state and B2's inputs at the last step."""
  from ble_tpu_torch.env import env as env_lib
  t_start = time.perf_counter()
  cadence = dataclasses.replace(params, field_cache_every=PARAMS_CACHE_EVERY)
  gen = torch.Generator(device=DEV).manual_seed(13)
  actions = [torch.randint(0, 3, (E,), generator=gen, device=DEV,
                           dtype=torch.int32) for _ in range(PARAMS_STEPS)]
  outs, oob, b2_inputs = [], [], []
  torch.cuda.synchronize()
  counts = _reset_counts()
  with _last_b2_inputs(b2_inputs):
    st = state
    for t, a in enumerate(actions):
      out = env_lib.step_batched(cadence, st, a, global_step=t)
      oob.append(out.info['slab_oob'].sum())
      st = out.state
      outs.append(out._replace(state=None))
    torch.cuda.synchronize()
  launches = counts()
  final = st
  st, same = state, []
  for t, a in enumerate(actions):
    if t % PARAMS_CACHE_EVERY == 0:
      st = env_lib.refresh_field_cache(st)
    ref = env_lib.step_batched(cadence, st, a, refresh='never')
    same.append(_same_step(outs[t], ref))
    st = ref.state
  leaves = []
  env_lib.tree_map(lambda x, y: leaves.append(torch.equal(x, y)), final, st)
  oob_envs = int(torch.stack(oob).sum())
  cadence_s = time.perf_counter() - t_start
  log(f'params: step_batched(global_step=t), field_cache_every='
      f'{PARAMS_CACHE_EVERY}, E={E}, {PARAMS_STEPS} steps: launches '
      f'{json.dumps(launches)}; envs outside their slab over the steps '
      f'{oob_envs}; equal in bits to a re-centre by hand: steps '
      f'{sum(same)}/{len(same)}, final state leaves '
      f'{sum(leaves)}/{len(leaves)}; {cadence_s:.1f} s')
  check(launches['physics'] == PARAMS_STEPS and
        launches['gp_window'] == PARAMS_STEPS,
        f'params: B1 and B2 not launched once a step: {launches}')
  check(launches['gp_observe'] == 0 and launches['gp_query'] == 0,
        'params: B3-B5 ran')
  check(oob_envs == 0, f'params: {oob_envs} balloon-steps outside the slab')
  check(all(same) and all(leaves),
        'params: the cadence departs from a re-centre by hand')
  log(f'params: phase {time.perf_counter() - t_start:.1f} s; '
      f'{nvidia_smi_line()}')
  return {'launches': {'physics_params': launches['physics'],
                       'gp_window_params': launches['gp_window']},
          'state': final, 'b2': b2_inputs}


WINDOW_K = 8
WINDOW_COUNT = 16
# The window against K sequential steps: tests/test_rollout_window.py:53-66
# (observations 2e-4, kinv 5e-3; rewards, done flags, positions, winds,
# active slots and counts equal).
WINDOW_OBS_ATOL = 2e-4
WINDOW_KINV_ATOL = 5e-3
BENCH_KEYS = {'metric', 'value', 'unit', 'vs_baseline'}


def check_window_agreement(params, state, actions, label: str) -> dict:
  """env.rollout_window over the K rows of `actions` against K step_batched
  calls from the same `state`, both on the card."""
  from ble_tpu_torch.env import env as env_lib
  got = env_lib.rollout_window(params, state, actions)
  outs = []
  st = state
  for a in actions:
    outs.append(env_lib.step_batched(params, st, a, refresh='never'))
    st = outs[-1].state
  seq = lambda f: torch.stack([f(o) for o in outs])
  want_obs = seq(lambda o: o.observation)
  equal = {
      'reward': torch.equal(got.reward, seq(lambda o: o.reward)),
      'done': torch.equal(got.done, seq(lambda o: o.done)),
      'info': all(torch.equal(got.info[k], seq(lambda o, k=k: o.info[k]))
                  for k in outs[0].info) and set(got.info) == set(
                      outs[0].info),
      'x_y_pressure': all(torch.equal(getattr(got.state.balloon, n),
                                      getattr(st.balloon, n))
                          for n in ('x_m', 'y_m', 'pressure_pa')),
      'winds': (torch.equal(got.state.wind_u, st.wind_u) and
                torch.equal(got.state.wind_v, st.wind_v)),
      'active': torch.equal(got.state.gp.active, st.gp.active),
      'count': torch.equal(got.state.gp.count, st.gp.count),
      'obs_bits': torch.equal(got.observation, want_obs),
      'kinv_bits': torch.equal(got.state.gp.kinv, st.gp.kinv),
  }
  readings = {
      'obs_max_abs_err': float((got.observation - want_obs).abs().max()),
      'kinv_max_abs_err': float((got.state.gp.kinv - st.gp.kinv).abs().max()),
      'equal': equal,
      'evicting_envs_at_last_step': int((st.gp.count > 128).sum()),
  }
  log(f'window agreement ({label}), rollout_window against '
      f'{len(actions)} step_batched:', json.dumps(readings))
  if equal['obs_bits'] and equal['kinv_bits']:
    log(f'window agreement ({label}): B2 at K = {len(actions)} and at '
        f'{len(actions)} x K = 1 give equal bits (observations and kinv)')
  for name in ('reward', 'done', 'info', 'x_y_pressure', 'winds', 'active',
               'count'):
    check(equal[name], f'window ({label}): {name} differs from step_batched')
  check(readings['obs_max_abs_err'] <= WINDOW_OBS_ATOL,
        f'window ({label}) observation error {readings["obs_max_abs_err"]}')
  check(readings['kinv_max_abs_err'] <= WINDOW_KINV_ATOL,
        f'window ({label}) kinv error {readings["kinv_max_abs_err"]}')
  return readings


def run_bench(mode: str) -> dict:
  """`python -m ble_tpu_torch.bench` as a user runs it, with its defaults
  (4096 generative envs, 32 steps, slab cache on, on the card) in `mode`:
  exactly one JSON line on stdout with bench.py's keys and a positive
  value."""
  import os
  env = {k: v for k, v in os.environ.items() if not k.startswith('BENCH_')}
  env['BENCH_MODE'] = mode
  t = time.perf_counter()
  proc = subprocess.run([sys.executable, '-m', 'ble_tpu_torch.bench'],
                        cwd=os.path.dirname(os.path.abspath(__file__)),
                        env=env, capture_output=True, text=True, timeout=600)
  wall_s = time.perf_counter() - t
  check(proc.returncode == 0,
        f'bench {mode} exited {proc.returncode}: {proc.stderr[-3000:]}')
  lines = proc.stdout.splitlines()
  check(len(lines) == 1, f'bench {mode} printed {len(lines)} lines')
  result = json.loads(lines[0])
  check(set(result) == BENCH_KEYS and result['value'] > 0 and
        f'({E} envs, generative winds, {mode}, cuda)' in result['metric'],
        f'bench {mode} line {lines[0]}')
  log(f'bench {mode} ({wall_s:.1f} s in all):', lines[0])
  return result


def phase_window(params, state0) -> dict:
  """The window route, env.rollout_window at K = WINDOW_K, from the main
  path's initial state (E = 4096 generative envs, slab cache on).

  Agreement: from the slab-re-centred state, one window against K
  step_batched calls (check_window_agreement); again after the run below,
  when the 128-slot ring is full and old points expire every step.
  Launches: WINDOW_COUNT windows (128 steps), the slab re-centred before
  each, with every count set to 0 just before and read just after: B1
  WINDOW_K times and B2 once a window, B3-B5 never; observations finite,
  rewards in [0, 1]. The same windows again from the same state, timed,
  must give the same values; two of them under torch.profiler give the
  device time and busy share. Then the bench in both modes. Returns the
  launches, the window path's final state, B2's inputs at the last
  window, and the summary."""
  from ble_tpu_torch.env import env as env_lib
  gen = torch.Generator(device=DEV).manual_seed(11)
  draw = lambda: torch.randint(0, 3, (WINDOW_K, E), generator=gen,
                               device=DEV, dtype=torch.int32)
  check_window_agreement(params, env_lib.refresh_field_cache(state0), draw(),
                         'from the reset')
  actions = [draw() for _ in range(WINDOW_COUNT)]

  def run(checks=None, windows=WINDOW_COUNT):
    st, values = state0, []
    for a in actions[:windows]:
      st = env_lib.refresh_field_cache(st)
      out = env_lib.rollout_window(params, st, a)
      if checks is not None:
        checks.append(torch.isfinite(out.observation).all() &
                      ((out.reward >= 0) & (out.reward <= 1)).all())
      values.append(out.reward + 1e-12 * out.observation.sum(-1))
      st = out.state
    return st, torch.cat(values)

  checks, b2_inputs = [], []
  torch.cuda.synchronize()
  counts = _reset_counts()
  with _last_b2_inputs(b2_inputs):
    t = time.perf_counter()
    _, values = run(checks)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
  launches = counts()
  steps = WINDOW_K * WINDOW_COUNT
  log(f'window: {WINDOW_COUNT} windows of K={WINDOW_K}, launches '
      f'{json.dumps(launches)}')
  check(launches['physics'] == steps,
        f'window: B1 launched {launches["physics"]} times in {steps} steps')
  check(launches['gp_window'] == WINDOW_COUNT,
        f'window: B2 launched {launches["gp_window"]} times in '
        f'{WINDOW_COUNT} windows')
  check(launches['gp_observe'] == 0 and launches['gp_query'] == 0,
        'window: B3-B5 ran')
  check(tuple(b2_inputs[1].shape) == (WINDOW_K, E, 8),
        f'window: B2 observations {tuple(b2_inputs[1].shape)}')
  check(bool(torch.stack(checks).all()),
        'window: observations not finite or rewards outside [0, 1]')

  before = torch.cuda.memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  t = time.perf_counter()
  final, values2 = run()
  torch.cuda.synchronize()
  second_s = time.perf_counter() - t
  check(torch.equal(values2, values), 'the two window runs differ')
  summary = {
      'envs': E, 'steps': steps, 'window': WINDOW_K,
      'first_run_s': first_s, 'second_run_s': second_s,
      'env_steps_per_s': E * steps / second_s,
      'ms_per_step': 1e3 * second_s / steps,
      'mean_reward': float(values2.mean()),
      'peak_memory_gb': torch.cuda.max_memory_allocated() / 1e9,
      'peak_above_held_gb': (torch.cuda.max_memory_allocated() - before) /
                            1e9,
  }
  # Two windows under torch.profiler: the device's share of the step.
  device_ms, per_step, _ = device_time(
      lambda: (run(windows=2), torch.cuda.synchronize()), 2 * WINDOW_K)
  summary.update({'device_ms_per_step': device_ms,
                  'device_launches_per_step': per_step,
                  'device_busy_share': device_ms / summary['ms_per_step']})
  log('window:', json.dumps(summary))
  check_window_agreement(params, env_lib.refresh_field_cache(final), draw(),
                         f'after {steps} steps')
  summary['bench'] = {mode: run_bench(mode) for mode in ('window', 'perstep')}
  return {'launches': {'physics_window': launches['physics'],
                       'gp_window_window': launches['gp_window']},
          'state': final, 'b2': b2_inputs, 'summary': summary}


TRAIN_E = 1024
# An env step takes ~2.9 s at full width on an H100 (80GB HBM3, 700 W), so
# the phase runs two chunks of 8 env steps, the first 5 filling the
# replay, to stay near a minute.
TRAIN_CHUNK = 8
TRAIN_SPLIT_STEPS = 2
# One train step on the card against the same step on the CPU from the
# same parameters, Adam state and batch, each reading the largest over the
# network's tensors. params: max |card - cpu| over max |cpu|. grads:
# |card - cpu| over |cpu| in norm. updates: |card - cpu| after the step
# over |cpu after - before| in norm, the step's own error, which params
# cannot see: at lr 2e-6 a whole step is ~5e-5 of max |w|. Two faulty
# steps on the card, against the same CPU step, show that the limits
# catch what they are for (check_train_step): TF32 matmuls and a rate
# 1.1 times too large.
TRAIN_PARAM_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4
TRAIN_UPDATE_RTOL = 1e-3


def _trees_equal(got, want) -> bool:
  """Nested dicts, lists and tuples of tensors and numbers, equal leaf for
  leaf (tensors compared on the CPU)."""
  if isinstance(want, dict):
    return set(got) == set(want) and all(_trees_equal(got[k], want[k])
                                         for k in want)
  if isinstance(want, (list, tuple)):
    return len(got) == len(want) and all(map(_trees_equal, got, want))
  if isinstance(want, torch.Tensor):
    return (got.dtype == want.dtype and got.shape == want.shape and
            torch.equal(got.cpu(), want.cpu()))
  return got == want


@contextlib.contextmanager
def _timed_learner(times: list, module=None, name: str = 'learn'):
  """Wraps the learner's share of an env step, `module.name` (by default
  learner.learn; mlp_agent.online_train for the online agent), in a host
  clock between two synchronisations; `times` gets one reading a call. The
  port itself carries no instrumentation."""
  if module is None:
    from ble_tpu_torch.train import learner as module
  learn = getattr(module, name)

  def timed(*args, **kwargs):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = learn(*args, **kwargs)
    torch.cuda.synchronize()
    times.append(time.perf_counter() - t)
    return out

  setattr(module, name, timed)
  try:
    yield
  finally:
    setattr(module, name, learn)


def _train_step_errs(learner, cpu, before) -> dict:
  """How far `learner`'s step lies from the CPU learner's (the readings
  of TRAIN_PARAM_RTOL, TRAIN_GRAD_RTOL and TRAIN_UPDATE_RTOL); `before`
  holds the parameters both started from. Tensors the optimizer does not
  train (the LSTM's frozen input-side bias) are left out."""
  errs = {'params': 0.0, 'grads': 0.0, 'updates': 0.0}
  got = dict(learner.network.named_parameters())
  for k, w in cpu.network.named_parameters():
    if not w.requires_grad:
      continue
    card, w, g = got[k].detach().cpu(), w.detach(), w.grad
    errs['params'] = max(errs['params'], float(
        (card - w).abs().max() / w.abs().max()))
    errs['grads'] = max(errs['grads'], float(
        (got[k].grad.cpu() - g).norm() / g.norm()))
    delta = w.double() - before[k]
    errs['updates'] = max(errs['updates'], float(
        (card.double() - w.double()).norm() / delta.norm()))
  return errs


# The field of TrainConfig that holds each trainable agent's own config.
AGENT_CONFIG = {'quantile': 'qrdqn', 'finetune_perciatelli': 'qrdqn',
                'dqn': 'dqn', 'r2d2': 'r2d2'}


@contextlib.contextmanager
def _tf32(matmul: bool, cudnn: bool):
  """TF32 allowed in cuBLAS matmuls and/or cuDNN (the LSTM) inside the
  block; the precision policy's full float32 restored after it."""
  torch.backends.cuda.matmul.allow_tf32 = matmul
  torch.backends.cudnn.allow_tf32 = cudnn
  try:
    yield
  finally:
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')
  check(not torch.backends.cuda.matmul.allow_tf32 and
        not torch.backends.cudnn.allow_tf32, 'TF32 left on')


def check_train_step(config, ts) -> dict:
  """One train step of the agent on the card against the same step on the
  CPU, from the card learner's parameters and Adam state and one replay
  batch (n-step, or sequence windows for r2d2): params, grads and updates
  (_train_step_errs) to their limits, the loss to 1e-5 relative. Then the
  controls, each a faulty step on the card from the same start against
  the same CPU step, each of which must break one of the limits: the step
  with TF32 in matmuls and cuDNN (which the precision policy rules out),
  and the step at 1.1 times the learning rate (a wrong optimizer); for a
  recurrent agent also the step with TF32 in cuDNN alone, which shows
  that the LSTM (cuDNN's on the card) runs in full float32."""
  import copy
  from ble_tpu_torch.agents import replay
  from ble_tpu_torch.train import learner as learner_lib
  from ble_tpu_torch.train import train_lib
  core = learner_lib.make_agent_core(config)
  name = config.agent
  if core.sample_kind == 'sequence':
    batch = replay.sample_sequence(ts.replay, config.replay, ts.generator,
                                   core.seq_len)
  else:
    batch = replay.sample(ts.replay, config.replay, ts.generator)
  start = copy.deepcopy(train_lib.learner_state_dict(ts.learner))

  def learner_at_start(device):
    learner = core.init(torch.Generator().manual_seed(0), ts.obs.shape[1],
                        device)
    train_lib.load_learner_state(learner, start)
    return learner

  cpu = learner_at_start('cpu')
  before = {k: v.detach().cpu().double()
            for k, v in ts.learner.network.state_dict().items()}
  _, card_m = core.train_step(ts.learner, batch, None)
  _, cpu_m = core.train_step(cpu, {k: v.cpu() for k, v in batch.items()},
                             None)
  errs = _train_step_errs(ts.learner, cpu, before)
  loss_err = abs(float(card_m['loss']) - float(cpu_m['loss'])) / abs(
      float(cpu_m['loss']))
  valid = ('' if 'valid_frac' not in cpu_m else
           f'; batch valid_frac {float(cpu_m["valid_frac"]):.3f}')
  log(f'{name}: one train_step card vs cpu, max over tensors of relative '
      f'|card - cpu|: {json.dumps(errs)}; loss {float(card_m["loss"]):.6g} '
      f'vs {float(cpu_m["loss"]):.6g} (relative {loss_err:.3g}){valid}')
  limits = {'params': TRAIN_PARAM_RTOL, 'grads': TRAIN_GRAD_RTOL,
            'updates': TRAIN_UPDATE_RTOL}
  for key, limit in limits.items():
    check(errs[key] <= limit, f'{name} train step {key} {errs[key]} > {limit}')
  check(loss_err <= 1e-5, f'{name} train step loss {loss_err}')

  controls = {}
  learner = learner_at_start(DEV)
  with _tf32(matmul=True, cudnn=True):
    core.train_step(learner, batch, None)
  controls['tf32'] = _train_step_errs(learner, cpu, before)
  if core.sample_kind == 'sequence':
    learner = learner_at_start(DEV)
    with _tf32(matmul=False, cudnn=True):
      core.train_step(learner, batch, None)
    controls['tf32 in cudnn alone'] = _train_step_errs(learner, cpu, before)
  field = AGENT_CONFIG[name]
  sub = getattr(config, field)
  faulty = dataclasses.replace(config, **{field: dataclasses.replace(
      sub, learning_rate=1.1 * sub.learning_rate)})
  learner = learner_at_start(DEV)
  learner_lib.make_agent_core(faulty).train_step(learner, batch, None)
  controls['lr x 1.1'] = _train_step_errs(learner, cpu, before)
  log(f'{name}: controls, faulty steps on the card vs the sound cpu step:',
      json.dumps(controls))
  for control, ctrl in controls.items():
    check(any(ctrl[k] > limit for k, limit in limits.items()),
          f'the {name} train-step limits pass the {control} control: {ctrl}')
  return errs


def check_train_checkpoints(config, ts) -> None:
  """A full and a light checkpoint written from the card and read back
  onto it, each into a fresh state (another network, an empty replay):
  every tensor, counter and the generator's state equal to what was
  saved."""
  import os
  import tempfile
  from ble_tpu_torch.train import learner as learner_lib
  from ble_tpu_torch.train import train_lib
  saved = train_lib.train_state_dict(ts)
  with tempfile.TemporaryDirectory() as d:
    t = time.perf_counter()
    path = train_lib.save_checkpoint(d, ts, 0)
    save_s = time.perf_counter() - t
    size = os.path.getsize(path)
    template = learner_lib.train_state_from_envs(config, ts.env_state,
                                                 ts.obs, seed=1)
    t = time.perf_counter()
    restored, iteration = train_lib.restore_latest_checkpoint(d, template)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    check(iteration == 0 and restored.replay.obs.is_cuda,
          'full checkpoint restored off the card')
    check(_trees_equal(train_lib.train_state_dict(restored), saved),
          'full checkpoint round trip differs')
    del restored, template
    light = train_lib.save_checkpoint(d, ts, 1, light=True)
    light_size = os.path.getsize(light)
    params, iteration = train_lib.restore_latest_learner_params(d)
    check(iteration == 1 and _trees_equal(
        params, ts.learner.network.state_dict()),
          'light checkpoint parameters differ')
    template = learner_lib.train_state_from_envs(config, ts.env_state,
                                                 ts.obs, seed=2)
    restored, _ = train_lib.restore_latest_checkpoint(d, template)
    check(_trees_equal(train_lib.learner_state_dict(restored.learner),
                       saved['learner']), 'light checkpoint learner differs')
    del restored, template
  log(f'train: checkpoints round-trip on the card: full {size / 1e9:.3f} GB '
      f'(saved in {save_s:.2f} s, restored in {load_s:.2f} s), light '
      f'{light_size / 1e6:.2f} MB')


@contextlib.contextmanager
def _last_b2_inputs(out: list):
  """Keeps in `out` a copy of (GP state, observations) of the last call
  to gp_window.window, the env step's route to B2."""
  from ble_tpu_torch.ops import gp_window
  window = gp_window.window

  def recorded(state, obs_seq):
    out[:] = [dataclasses.replace(state, **{
        f.name: getattr(state, f.name).clone()
        for f in dataclasses.fields(state)}), obs_seq.clone()]
    return window(state, obs_seq)

  gp_window.window = recorded
  try:
    yield
  finally:
    gp_window.window = window


def check_train_cli(config) -> None:
  """`python -m ble_tpu_torch.train.train --agent quantile` as a user runs
  it, with no --device (so on the card) and TrainConfig's defaults, cut
  to one iteration of TRAIN_CHUNK env steps in a temporary base_dir: B1
  and B2 launch every env step, train_steps is 256 x the steps that could
  sample, replay.total the steps, and the full checkpoint of the
  iteration is written. The same command again resumes from it at
  iteration 1 of 1, so takes no step: its learner equals the first
  run's."""
  import os
  import tempfile
  from ble_tpu_torch.train import train
  with tempfile.TemporaryDirectory() as d:
    argv = ['--agent', 'quantile', '--base_dir', d, '--num_iterations', '1',
            '--max_episode_length', str(TRAIN_CHUNK)]
    counts = _reset_counts()
    t = time.perf_counter()
    ts = train.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    launches = counts()
    ckpts = sorted(os.listdir(os.path.join(d, 'checkpoints')))
    first = (config.qrdqn.min_replay_history // config.num_envs +
             config.replay.n_step)
    trained = max(TRAIN_CHUNK - first, 0)
    check(ts.replay.obs.is_cuda and tuple(ts.replay.obs.shape) ==
          (config.num_envs, config.replay.ring_len, ts.obs.shape[1]),
          'train CLI: replay not on the card at full size')
    check(launches['physics'] >= TRAIN_CHUNK and
          launches['gp_window'] >= TRAIN_CHUNK,
          f'train CLI: B1 or B2 not launched every step: {launches}')
    check(ts.replay.total == TRAIN_CHUNK == ts.env_steps,
          f'train CLI: replay.total {ts.replay.total}')
    check(ts.learner.train_steps == config.grad_steps_per_env_step() *
          trained, f'train CLI: train_steps {ts.learner.train_steps}')
    check(ckpts == ['ckpt_00000000.pt'], f'train CLI checkpoints {ckpts}')
    check(bool(torch.isfinite(ts.obs).all()), 'train CLI obs not finite')
    saved = {k: v.clone() for k, v in ts.learner.network.state_dict().items()}
    train_steps = ts.learner.train_steps
    del ts
    t = time.perf_counter()
    ts = train.main(argv)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t
    check(ts.learner.train_steps == train_steps and
          ts.replay.total == TRAIN_CHUNK and
          _trees_equal(ts.learner.network.state_dict(), saved),
          'train CLI did not resume from its checkpoint')
    del ts
  log(f'train: CLI {" ".join(argv[:2] + argv[4:])}: {run_s:.2f} s, '
      f'launches {json.dumps(launches)}, {train_steps} train steps; '
      f'resumed without a step in {resume_s:.2f} s')


def phase_train(field_fn):
  """The training path at full width: run_training_loop's own pieces
  (init_train_state, run_episode_chunk, selective_reset) with TrainConfig's
  defaults at E = 1024 generative envs: the 8 x 600, 51-atom quantile
  network, replay ring 512 with batch 32 and n-step 5, 256 train steps an
  env step once replay can sample, MarcoPolo on, slab cache on. Two chunks
  of TRAIN_CHUNK env steps with a selective_reset between them in which
  every eighth env is forced inactive. B1 and B2 must launch every env
  step; train_steps must be 256 x the env steps at which replay could
  sample; the losses finite; replay.total the steps. Then
  TRAIN_SPLIT_STEPS more steps with the learner timed apart, one more
  under torch.profiler, one train_step against the CPU, the checkpoint
  round trips, and the training CLI (check_train_cli). Returns the path's
  launches, its final state, B2's inputs at the last env step of the
  second chunk (the train rows' data) and its readings."""
  from torch.autograd import DeviceType
  from ble_tpu_torch.env import env as env_lib
  from ble_tpu_torch.train import learner as learner_lib
  params = env_lib.EnvParams(field_cache=True)
  config = learner_lib.TrainConfig(num_envs=TRAIN_E)
  torch.cuda.reset_peak_memory_stats()
  t = time.perf_counter()
  ts = learner_lib.init_train_state(0, params, field_fn, config, DEV)
  torch.cuda.synchronize()
  log(f'train: init_train_state at E={TRAIN_E} in '
      f'{time.perf_counter() - t:.2f} s')
  net = ts.learner.network
  check(len(net.layers) == 8 and net.layers[0].out_features == 600 and
        net.num_atoms == 51, 'train network is not 8 x 600, 51 atoms')
  check(tuple(ts.replay.obs.shape) == (TRAIN_E, 512, 1099) and
        config.replay.batch_size == 32 and config.replay.n_step == 5 and
        config.use_marco_polo, 'train replay or exploration not full size')
  per_env_step = config.grad_steps_per_env_step()
  check(per_env_step == 256, f'{per_env_step} train steps an env step')

  counts = _reset_counts()
  t = time.perf_counter()
  ts, m1 = learner_lib.run_episode_chunk(config, params, ts, TRAIN_CHUNK)
  torch.cuda.synchronize()
  chunk1_s = time.perf_counter() - t
  forced = torch.arange(TRAIN_E, device=DEV) % 8 == 0
  ts.active = ts.active & ~forced
  t = time.perf_counter()
  ts, stats = learner_lib.selective_reset(ts, params, field_fn, config)
  torch.cuda.synchronize()
  reset_s = time.perf_counter() - t
  b2_inputs = []
  t = time.perf_counter()
  with _last_b2_inputs(b2_inputs):
    ts, m2 = learner_lib.run_episode_chunk(config, params, ts, TRAIN_CHUNK)
  torch.cuda.synchronize()
  chunk2_s = time.perf_counter() - t
  launches = counts()
  steps = 2 * TRAIN_CHUNK
  log(f'train: launches {json.dumps(launches)} in {steps} env steps')
  check(launches['physics'] >= steps, 'train: B1 was not launched per step')
  check(launches['gp_window'] >= steps, 'train: B2 was not launched per step')
  first = (config.qrdqn.min_replay_history // TRAIN_E +
           config.replay.n_step)
  trained = sum(1 for s in range(steps) if s + 1 > first)
  check(ts.learner.train_steps == per_env_step * trained,
        f'train_steps {ts.learner.train_steps} != {per_env_step} x {trained}')
  check(ts.replay.total == steps and ts.env_steps == steps,
        f'replay.total {ts.replay.total} after {steps} steps')
  loss = torch.cat([m1['loss'], m2['loss']])
  check(bool(torch.isfinite(loss).all()), 'train loss not finite')
  check(bool((loss[first:] > 0).all()), 'train loss 0 while training')
  completed = stats['completed']
  check(bool(completed[forced].all()) and
        ts.episodes_done == int(completed.sum()),
        'train: forced envs were not reset')
  rewards = torch.cat([m1['reward'], m2['reward']])
  check(bool(torch.isfinite(rewards).all()), 'train rewards not finite')
  check(bool(torch.isfinite(ts.obs).all()), 'train observations not finite')
  hist = (m1['action_hist'].sum(0) + m2['action_hist'].sum(0)).tolist()

  times = []
  t = time.perf_counter()
  with _timed_learner(times):
    ts, _ = learner_lib.run_episode_chunk(config, params, ts,
                                          TRAIN_SPLIT_STEPS)
  torch.cuda.synchronize()
  split_s = time.perf_counter() - t
  learner_s = sum(times)
  check(len(times) == TRAIN_SPLIT_STEPS, 'train: the learner did not run')

  def one_step():
    nonlocal ts
    ts, _ = learner_lib.env_step(config, params, ts)
    torch.cuda.synchronize()

  # One profile: each takes ~50 s for its ~69,000 launches, and a second
  # one, once taken in case the first lost kernel records, never found
  # more launches.
  with _train_ranges():
    device_ms, launches_per_step, events = device_time(one_step, 1)
  log('train: profiled env step (device ms, launches):',
      [device_ms, launches_per_step])
  ranges = {e.key: e.cpu_time_total / 1e3 for e in events
            if e.key.startswith('step/') and e.device_type == DeviceType.CPU}
  wall_ms = 1e3 * split_s / TRAIN_SPLIT_STEPS
  log('train: profile of one env step: host ms by part, nested parts '
      'inside their callers (profiled):',
      json.dumps({k: round(v, 2) for k, v in sorted(ranges.items())}))
  log(f'train: profile of one env step: {device_ms:.2f} ms of device '
      f'kernels in {launches_per_step:.0f} launches '
      f'({launches_per_step / per_env_step:.1f} a train step); device busy '
      f'share {device_ms / wall_ms:.3f} of the unprofiled '
      f'{wall_ms:.1f} ms')
  log(events.table(sort_by='self_cpu_time_total', row_limit=20,
                   max_name_column_width=60))
  summary = {
      'envs': TRAIN_E, 'env_steps': steps, 'trained_env_steps': trained,
      'train_steps': per_env_step * trained,
      # Over the second chunk, where every env step trains.
      'env_steps_per_s': TRAIN_E * TRAIN_CHUNK / chunk2_s,
      'chunk_s': [chunk1_s, chunk2_s], 'reset_s': reset_s,
      'reset_envs': int(completed.sum()),
      'loss_first_last': [float(loss[first]), float(loss[-1])],
      'mean_reward': float(rewards.mean()), 'action_hist': hist,
      'split_env_steps_per_s': TRAIN_E * TRAIN_SPLIT_STEPS / split_s,
      'split_grad_steps_per_s': per_env_step * TRAIN_SPLIT_STEPS / learner_s,
      'split_ms_per_env_step': 1e3 * split_s / TRAIN_SPLIT_STEPS,
      'split_learner_ms_per_env_step': 1e3 * learner_s / TRAIN_SPLIT_STEPS,
      'split_env_ms_per_env_step':
          1e3 * (split_s - learner_s) / TRAIN_SPLIT_STEPS,
      'peak_memory_gb': torch.cuda.max_memory_allocated() / 1e9,
  }
  log(f'train: {nvidia_smi_line()}:', json.dumps(summary))
  check_train_step(config, ts)
  check_train_checkpoints(config, ts)
  check_train_cli(config)
  return {'physics_train': launches['physics'],
          'gp_window_train': launches['gp_window']}, ts, b2_inputs, summary


# The agents of phase `agents`, each at its default (full) width.
AGENTS = ('dqn', 'finetune_perciatelli', 'mlp', 'r2d2')
AGENTS_CHUNK = 8
AGENTS_TIMED_STEPS = 2
# The episode of the r2d2 eval CLI and of phase distributed's: micro_eval's
# one seed, cut from 960 steps for the script's time limit (960 steps of
# one env took 79-131 s).
AGENTS_EVAL_STEPS = 128


def _agent_widths(config, network) -> dict:
  """The network's widths, checked against the agent's default config."""
  if config.agent == 'r2d2':
    rc = config.r2d2
    check(len(network.torso) == rc.torso_layers == 2 and
          network.torso[0].out_features == rc.hidden_units == 600 and
          network.lstm_units == rc.lstm_units == 256 and
          network.num_atoms == rc.num_atoms == 51 and network.duelling,
          'r2d2 network is not 2 x 600, LSTM 256, duelling 51 atoms')
    return {'torso': [600, 600], 'lstm': 256, 'atoms': 51, 'duelling': True}
  if config.agent == 'mlp':
    check(len(network.layers) == 1 and network.layers[0].in_features == 1099
          and network.layers[0].out_features == 3,
          'mlp network is not one linear layer 1099 -> 3')
    return {'layers': [1099, 3]}
  check(len(network.layers) == 8 and network.layers[0].out_features == 600,
        f'{config.agent} network is not 8 x 600')
  out = {'layers': 8, 'hidden': 600}
  if config.agent == 'finetune_perciatelli':
    check(network.num_atoms == 51, 'finetune network has not 51 atoms')
    out['atoms'] = 51
  return out


def run_agent(name, params, field_fn, env_state, obs, counts) -> dict:
  """One trainable agent at its default config over E = TRAIN_E envs from
  `env_state` (cloned), MarcoPolo on: one run_episode_chunk of
  AGENTS_CHUNK env steps; for the agents with per-env lanes (mlp, r2d2)
  a selective_reset with every eighth env forced inactive, whose lanes
  must be dropped; for r2d2 a second chunk (its first trainable window
  step needs burn_in + 2 = 10 written slots); then AGENTS_TIMED_STEPS
  steps with the learner timed apart, and one more, under
  torch.profiler for mlp and r2d2. Gates: B1 and B2 launched every env step; train_steps = the agent's
  train steps an env step x the steps at which replay could sample (mlp:
  one SGD step every env step); losses finite; the online parameters
  moved; replay.total = the steps."""
  from ble_tpu_torch.agents import mlp_agent
  from ble_tpu_torch.env import env as env_lib
  from ble_tpu_torch.train import learner as learner_lib
  config = learner_lib.TrainConfig(agent=name, num_envs=TRAIN_E)
  core = learner_lib.make_agent_core(config)
  torch.cuda.reset_peak_memory_stats()
  t = time.perf_counter()
  ts = learner_lib.train_state_from_envs(
      config, env_lib.tree_map(torch.clone, env_state), obs.clone(), seed=0)
  torch.cuda.synchronize()
  init_s = time.perf_counter() - t
  widths = _agent_widths(config, ts.learner.network)
  check(tuple(ts.replay.obs.shape) == (TRAIN_E, 512, 1099) and
        config.use_marco_polo, f'{name}: replay or exploration not full size')
  start = [p.detach().clone() for p in ts.learner.network.parameters()]
  before = counts()
  losses, b2_inputs, chunk_s = [], [], []

  def chunk(ts, steps):
    t = time.perf_counter()
    with _last_b2_inputs(b2_inputs):
      ts, m = learner_lib.run_episode_chunk(config, params, ts, steps)
    torch.cuda.synchronize()
    chunk_s.append(time.perf_counter() - t)
    losses.append(m['loss'])
    check(bool(torch.isfinite(m['reward']).all()), f'{name}: rewards')
    return ts

  ts = chunk(ts, AGENTS_CHUNK)
  steps = AGENTS_CHUNK
  reset = {}
  if core.on_reset is not None or core.actor_reset is not None:
    forced = torch.arange(TRAIN_E, device=DEV) % 8 == 0
    ts.active = ts.active & ~forced
    ts, _ = learner_lib.selective_reset(ts, params, field_fn, config)
    if name == 'mlp':
      check(not bool(ts.learner.p_valid[forced].any()) and
            bool(ts.learner.p_valid[~forced].all()),
            'mlp: reset envs kept their pending lanes')
    else:
      for c in ts.actor:
        check(not bool(c[forced].any()) and bool(c[~forced].any()),
              'r2d2: reset envs kept their LSTM carry')
    reset = {'forced_envs': int(forced.sum())}
  if name == 'r2d2':
    ts = chunk(ts, AGENTS_CHUNK)
    steps += AGENTS_CHUNK

  times = []
  module, fn = ((mlp_agent, 'online_train') if not core.uses_replay
                else (learner_lib, 'learn'))
  t = time.perf_counter()
  with _timed_learner(times, module, fn):
    ts = chunk(ts, AGENTS_TIMED_STEPS)
  split_s = time.perf_counter() - t
  steps += AGENTS_TIMED_STEPS
  check(len(times) == AGENTS_TIMED_STEPS, f'{name}: the learner did not run')

  def one_step():
    nonlocal ts
    ts, m = learner_lib.env_step(config, params, ts)
    losses.append(m['loss'][None])
    torch.cuda.synchronize()

  if name in ('dqn', 'finetune_perciatelli'):
    # 256 train steps an env step: a profiled 1024-env step takes ~40 s.
    # Phase train profiles quantile's, whose network finetune shares and
    # whose step dqn's mirrors (233.3 launches a train step when last
    # profiled, H100 80GB HBM3 at 700 W).
    one_step()
    device_ms = profiled_launches = None
  else:
    device_ms, profiled_launches, _ = device_time(one_step, 1)
  steps += 1
  after = counts()
  launches = {k: after[k] - before[k] for k in after}
  check(launches['physics'] >= steps and launches['gp_window'] >= steps,
        f'{name}: B1 or B2 not launched every env step: {launches}')
  per_env_step = (config.grad_steps_per_env_step() if core.uses_replay
                  else 1)
  if core.uses_replay:
    first = core.min_replay_history // TRAIN_E + config.replay.n_step
    trained = sum(1 for total in range(1, steps + 1) if total > first)
  else:
    trained = steps
  check(ts.learner.train_steps == per_env_step * trained,
        f'{name}: train_steps {ts.learner.train_steps} != {per_env_step} x '
        f'{trained}')
  check(ts.replay.total == steps == ts.env_steps,
        f'{name}: replay.total {ts.replay.total} after {steps} steps')
  loss = torch.cat(losses)
  check(bool(torch.isfinite(loss).all()), f'{name}: loss not finite')
  check(bool((loss > 0).any()), f'{name}: loss never above 0')
  moved = any(not torch.equal(a, b) for a, b in
              zip(start, ts.learner.network.parameters()))
  check(moved, f'{name}: the online parameters did not move')
  check(bool(torch.isfinite(ts.obs).all()), f'{name}: observations')
  learner_s = sum(times)
  wall_ms = 1e3 * split_s / AGENTS_TIMED_STEPS
  summary = {
      'widths': widths, 'envs': TRAIN_E, 'env_steps': steps,
      'trained_env_steps': trained, 'train_steps': ts.learner.train_steps,
      'train_steps_per_env_step': per_env_step, **reset,
      'init_s': init_s, 'chunk_s': chunk_s,
      'env_steps_per_s': TRAIN_E * AGENTS_TIMED_STEPS / split_s,
      'grad_steps_per_s': per_env_step * AGENTS_TIMED_STEPS / learner_s,
      'ms_per_env_step': wall_ms,
      'learner_ms_per_env_step': 1e3 * learner_s / AGENTS_TIMED_STEPS,
      'env_ms_per_env_step': 1e3 * (split_s - learner_s) / AGENTS_TIMED_STEPS,
      'profiled_device_ms_per_env_step': device_ms,
      'profiled_launches_per_env_step': profiled_launches,
      'launches_per_train_step': (None if profiled_launches is None else
                                  profiled_launches / per_env_step),
      'device_busy_share': None if device_ms is None else device_ms / wall_ms,
      'loss_first_nonzero_last': [float(loss[loss > 0][0]),
                                  float(loss[-1])],
      'launches': launches,
      'peak_memory_gb': torch.cuda.max_memory_allocated() / 1e9,
  }
  log(f'agents: {name} on {nvidia_smi_line()}:', json.dumps(summary))
  return {'ts': ts, 'launches': launches, 'b2': b2_inputs,
          'summary': summary}


def check_agent_clis(config) -> None:
  """`train --agent r2d2` as a user runs it (no --device, so on the card,
  TrainConfig's defaults) for one iteration of AGENTS_CHUNK env steps: B1
  and B2 launched every env step, its train steps, its full checkpoint;
  then `eval --agent r2d2 --checkpoint_dir` on it over micro_eval (one
  seed, cut to AGENTS_EVAL_STEPS steps): finite rewards, time within
  radius in [0, 1], at most that many steps taken; and the
  eval CLI's r2d2 policy threads its LSTM carry (zero at the start,
  moved after a step)."""
  import os
  import tempfile
  from ble_tpu_torch.train import eval as eval_cli
  from ble_tpu_torch.train import suites
  from ble_tpu_torch.train import train
  with tempfile.TemporaryDirectory() as d:
    argv = ['--agent', 'r2d2', '--base_dir', d, '--num_iterations', '1',
            '--max_episode_length', str(AGENTS_CHUNK)]
    counts = _reset_counts()
    t = time.perf_counter()
    ts = train.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    launches = counts()
    first = config.r2d2.min_replay_history // TRAIN_E + config.replay.n_step
    check(launches['physics'] >= AGENTS_CHUNK and
          launches['gp_window'] >= AGENTS_CHUNK,
          f'r2d2 train CLI: B1 or B2 not launched every step: {launches}')
    check(ts.replay.total == AGENTS_CHUNK and ts.learner.train_steps ==
          config.grad_steps_per_env_step() * (AGENTS_CHUNK - first),
          f'r2d2 train CLI: train_steps {ts.learner.train_steps}')
    check(ts.replay.obs.is_cuda and ts.actor[0].is_cuda and
          tuple(ts.actor[0].shape) == (TRAIN_E, 256),
          'r2d2 train CLI: state not on the card at full size')
    ckpts = sorted(os.listdir(os.path.join(d, 'checkpoints')))
    check(ckpts == ['ckpt_00000000.pt'], f'r2d2 train CLI checkpoints {ckpts}')
    obs = ts.obs[:4].clone()
    del ts
    torch.cuda.empty_cache()

    policy_init, policy_step, _ = eval_cli.make_policy_fns('r2d2', d, DEV)
    carry = policy_init(torch.zeros((4, 2), dtype=torch.int64), DEV)
    check(all(c.is_cuda and tuple(c.shape) == (4, 256) and not bool(c.any())
              for c in carry), 'r2d2 eval policy: carry not zero at start')
    carry, actions = policy_step(carry, obs, None)
    check(all(bool(c.any()) for c in carry) and actions.is_cuda,
          'r2d2 eval policy: the carry did not move')

    out_dir = os.path.join(d, 'eval')
    get_eval_suite = suites.get_eval_suite
    seeds = get_eval_suite('micro_eval').seeds
    suites.get_eval_suite = lambda name: suites.EvaluationSuite(
        seeds, AGENTS_EVAL_STEPS)
    t = time.perf_counter()
    try:
      eval_cli.main(['--agent', 'r2d2', '--checkpoint_dir', d, '--suite',
                     'micro_eval', '--output_dir', out_dir])
    finally:
      suites.get_eval_suite = get_eval_suite
    eval_s = time.perf_counter() - t
    with open(os.path.join(out_dir, 'r2d2_micro_eval.json')) as f:
      results = json.load(f)['results']
    check(len(results) == 1 and
          0.0 <= results[0]['time_within_radius'] <= 1.0 and
          np.isfinite(results[0]['cumulative_reward']) and
          0 < results[0]['final_timestep'] <= AGENTS_EVAL_STEPS,
          f'r2d2 eval CLI results {results}')
  log(f'agents: train CLI {" ".join(argv[:2] + argv[4:])}: {train_s:.2f} s, '
      f'launches {json.dumps(launches)}; eval CLI --agent r2d2 --suite '
      f'micro_eval (cut to {AGENTS_EVAL_STEPS} steps) on its checkpoint: '
      f'{eval_s:.2f} s, '
      f'{results[0]["final_timestep"]} steps, cumulative reward '
      f'{results[0]["cumulative_reward"]:.3f}, time within radius '
      f'{results[0]["time_within_radius"]:.3f}')


def check_perciatelli44(obs) -> None:
  """Perciatelli44 from synthetic 8 x 600, 51-atom parameters (no trained
  blob is in the repository) acts on the card through make_policy: the
  agent's actions on a few of `obs` equal the same network's greedy
  actions on the CPU."""
  from ble_tpu_torch.agents import perciatelli44
  from ble_tpu_torch.agents import qrdqn
  params = qrdqn.init(torch.Generator().manual_seed(3), qrdqn.QrDqnConfig(),
                      1099, 'cpu').network.state_dict()
  agent = perciatelli44.Perciatelli44(3, (1099,), params=params)
  obs = obs[:8].cpu().numpy()
  got = [agent.begin_episode(obs[0])] + [agent.step(0.0, o) for o in obs[1:]]
  cpu = perciatelli44.make_policy(qrdqn.network_from_params(params,
                                                            device='cpu'))
  want = cpu(torch.from_numpy(obs)).tolist()
  check(got == want, f'Perciatelli44 on the card {got} != cpu {want}')
  log(f'agents: Perciatelli44(params=synthetic) on the card acts as on the '
      f'cpu: {got}')


def phase_agents(field_fn) -> dict:
  """The other trainable agents at full width: dqn (8 x 600 MLP, Adam lr
  2e-6, epsilon 0.01), finetune_perciatelli (the 8 x 600, 51-atom QR-DQN;
  no blob is in the repository, so a random init with a warning), mlp
  (the online SARSA layer 1099 -> 3) and r2d2 (2 x 600 torso, LSTM 256,
  duelling 51 atoms, windows of 24 with burn-in 8, 16 train steps an env
  step), each from its own TrainState around one reset of E = TRAIN_E
  generative envs (run_agent). Then one train step on the card against
  the CPU for dqn and r2d2 (check_train_step: phase train's limits and
  controls), the r2d2 train and eval CLIs (check_agent_clis) and
  Perciatelli44 on the card (check_perciatelli44). Returns the path's
  launches over the four agents' runs, r2d2's final env state and its
  last B2 inputs (the agents rows' data)."""
  from ble_tpu_torch.env import env as env_lib
  from ble_tpu_torch.models import loader
  from ble_tpu_torch.train import learner as learner_lib
  params = env_lib.EnvParams(field_cache=True)
  first = learner_lib.first_world_seed(0)
  t = t0 = time.perf_counter()
  env_state, obs = env_lib.reset(params, list(range(first, first + TRAIN_E)),
                                 field_fn, DEV)
  torch.cuda.synchronize()
  log(f'agents: reset of E={TRAIN_E} generative envs in '
      f'{time.perf_counter() - t:.2f} s')
  try:
    loader.load_perciatelli44()
  except FileNotFoundError:
    log('agents: finetune_perciatelli starts from the random init (no '
        'perciatelli44 blob; the learner logs a warning)')
  counts = _reset_counts()
  launches = {'physics': 0, 'gp_window': 0}
  summaries = {}
  out = None
  for name in AGENTS:
    run = run_agent(name, params, field_fn, env_state, obs, counts)
    for k in launches:
      launches[k] += run['launches'][k]
    summaries[name] = run['summary']
    if name in ('dqn', 'r2d2'):
      check_train_step(learner_lib.TrainConfig(agent=name, num_envs=TRAIN_E),
                       run['ts'])
    if name == 'r2d2':
      out = {'state': run['ts'].env_state, 'b2': run['b2'],
             'obs': run['ts'].obs}
    del run
    torch.cuda.empty_cache()
  log('agents: launches over the four runs', json.dumps(launches))
  log('agents: env-steps/s', json.dumps(
      {k: v['env_steps_per_s'] for k, v in summaries.items()}))
  log(f'agents: the four runs and their checks in '
      f'{time.perf_counter() - t0:.1f} s')
  check_agent_clis(learner_lib.TrainConfig(agent='r2d2', num_envs=TRAIN_E))
  check_perciatelli44(out['obs'])
  log(f'agents: phase done in {time.perf_counter() - t0:.1f} s')
  return {'launches': {'physics_agents': launches['physics'],
                       'gp_window_agents': launches['gp_window']},
          'state': out['state'], 'b2': out['b2'], 'summaries': summaries}


# ------------------------------------------------------- distributed ----


# Part (a): one chunk of DIST_CHUNK env steps of the distributed CLI at
# world 1 (NCCL), the chunk's last step under torch.profiler. Part (b):
# two ranks of GLOO_E envs on the one card over gloo (NCCL refuses two
# ranks on one GPU), GLOO_STEPS steps on each side of a forced reset, then
# GLOO_LEARN_STEPS with learning on. Part (c): the sharded eval of
# SHARD_SEEDS seeds for SHARD_STEPS steps. Part (d): TP_STEPS steps of the
# tensor-parallel demo on a (1, 1) mesh.
DIST_CHUNK = 8
# `--set` overrides of part (a)'s CLI and its reference run: none, so
# TrainConfig's defaults (a CPU rehearsal cuts them).
DIST_SETS = ()
GLOO_E = 64
GLOO_STEPS = 4
GLOO_LEARN_STEPS = 8
SHARD_SEEDS = 16
SHARD_STEPS = 64
TP_STEPS = 10
WORKER_TIMEOUT_S = 480
ALLREDUCE_LABEL = 'learner: train step: all-reduce'


def _start(cmd: list):
  """Starts `cmd` from the script's directory with its output in a
  temporary file; returns (name, process, file)."""
  import os
  import tempfile
  f = tempfile.TemporaryFile(mode='w+')
  proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, text=True,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
  return ' '.join(cmd[1:4]), proc, f


def _stop(started) -> None:
  """Kills whatever of `started` still runs."""
  for _, proc, _ in started:
    if proc.poll() is None:
      proc.kill()
      proc.wait()


def _finish(started, timeout: float = WORKER_TIMEOUT_S) -> list:
  """Waits for `started` (from _start), kills any still running at the
  timeout, logs each one's output and fails if one failed. Returns their
  outputs."""
  try:
    deadline = time.monotonic() + timeout
    for _, proc, _ in started:
      proc.wait(timeout=max(deadline - time.monotonic(), 1.0))
  finally:
    _stop(started)
  outs = []
  for name, proc, f in started:
    f.seek(0)
    outs.append(f.read())
    f.close()
    log(f'{name} (exit {proc.returncode}):\n{outs[-1].rstrip()}')
    check(proc.returncode == 0, f'{name} failed: {proc.returncode}')
  return outs


def _run_workers(argvs, timeout: float = WORKER_TIMEOUT_S) -> list:
  """Runs `python3 chip_smoke.py --worker <argv>` for each argv, all at
  once (_finish); returns their outputs."""
  import os
  return _finish([_start([sys.executable, os.path.abspath(__file__),
                          '--worker', *argv]) for argv in argvs], timeout)


def _gloo_config(num_envs: int, learning: bool):
  """Part (b)'s learner: QR-DQN 2 x 64, 11 atoms, greedy, MarcoPolo off;
  without learning, min_replay_history beyond the run."""
  from ble_tpu_torch.agents import qrdqn
  from ble_tpu_torch.agents import replay
  from ble_tpu_torch.train import learner as learner_lib
  return learner_lib.TrainConfig(
      num_envs=num_envs, use_marco_polo=False,
      qrdqn=qrdqn.QrDqnConfig(num_layers=2, hidden_units=64, num_atoms=11,
                              min_replay_history=2 if learning else 10**6),
      replay=replay.ReplayConfig(ring_len=32, batch_size=32))


def _forced(num_envs: int) -> torch.Tensor:
  """The envs part (b) forces into its reset: every fifth from index 1."""
  return torch.arange(num_envs, device=DEV) % 5 == 1


def _recording(field_fn, seen: list):
  """field_fn, noting the forecast keys of each reset."""
  def recorded(keys, device):
    seen.append(keys.tolist())
    return field_fn(keys, device)
  return recorded


def _gloo_snapshot(ts, seen) -> dict:
  rep = ts.replay
  return {'obs': ts.obs.cpu(),
          'pressure': ts.env_state.balloon.pressure_pa.cpu(),
          'replay': {k: getattr(rep, k).cpu() for k in (
              'obs', 'action', 'reward', 'terminal', 'valid')},
          'seeds': [list(s) for s in seen],
          'counters': [rep.total, ts.next_world_seed, ts.episodes_done,
                       ts.env_steps]}


def _allreduce_ms(grads, init_method: str) -> dict:
  """The gradient all-reduce alone on the run's gradients, in a new
  world-1 group, by CUDA events over back-to-back calls (host-bound, so
  what each call costs the train step): grad_allreduce's one collective,
  and one all-reduce and division a tensor, what the flat buffer
  replaces."""
  from ble_tpu_torch.parallel import distributed
  distributed.init_process_group(DEV, rank=0, world_size=1,
                                 init_method=init_method)
  try:
    flat = distributed.grad_allreduce(1)

    def per_tensor():
      for g in grads:
        torch.distributed.all_reduce(g)
        g.div_(1)

    return {'tensors': len(grads),
            'mb': 4e-6 * sum(g.numel() for g in grads),
            'flat_ms': cuda_ms(lambda: flat(grads), reps=50),
            'per_tensor_ms': cuda_ms(per_tensor, reps=50)}
  finally:
    torch.distributed.destroy_process_group()


def worker_train(out_path: str, timing: str, *cli_argv) -> None:
  """Part (a) in a process of its own: `distributed_train.main(cli_argv)`
  (world 1: one worker, in this process), each env step timed between
  two synchronisations with the learner timed apart, the chunk's last env
  step under torch.profiler with the gradient all-reduce in a range of
  its own. Then B1 and B2 against their plain versions on the run's final
  state and last B2 inputs, and, with `timing`, their rows' times. Writes
  its readings as JSON to out_path."""
  from torch.autograd import DeviceType
  import ble_tpu_torch  # noqa: F401  (sets the float32 precision policy)
  from ble_tpu_torch.env import env as env_lib
  from ble_tpu_torch.parallel import distributed
  from ble_tpu_torch.train import distributed_train
  from ble_tpu_torch.train import learner as learner_lib
  step_s, learn_s, losses, session = [], [], [], []
  env_step = learner_lib.env_step

  def timed_env_step(*args, **kwargs):
    torch.cuda.synchronize()
    t = time.perf_counter()
    if len(step_s) == DIST_CHUNK - 1:
      out = []

      def run():
        out.append(env_step(*args, **kwargs))
        torch.cuda.synchronize()

      with _train_ranges(), _ranges([(distributed.grad_allreduce,
                                      '__call__', ALLREDUCE_LABEL)]):
        session.append(device_time(run, 1))
      result = out[0]
    else:
      result = env_step(*args, **kwargs)
    torch.cuda.synchronize()
    step_s.append(time.perf_counter() - t)
    losses.append(float(result[1]['loss']))
    return result

  b2 = []
  counts = _reset_counts()
  learner_lib.env_step = timed_env_step
  try:
    with _timed_learner(learn_s), _last_b2_inputs(b2):
      ts = distributed_train.main(list(cli_argv))
  finally:
    learner_lib.env_step = env_step
  launches = counts()
  check(ts is not None and ts.obs.device.type == torch.device(DEV).type,
        'distributed CLI: no state on the card')

  device_ms, launches_per_step, events = session[0]
  cuda = [e for e in events
          if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
  nccl = [e for e in cuda if 'nccl' in e.key.lower()]
  parts = [e for e in events
           if e.key.startswith('step/') and e.device_type == DeviceType.CPU]
  ranges = {e.key[len('step/'):]: e.cpu_time_total / 1e3 for e in parts}
  device_ranges = {e.key[len('step/'):]: e.device_time_total / 1e3
                   for e in parts}
  per_env_step = ts.learner.train_steps // max(len(learn_s), 1)
  # The unprofiled env steps that trained: each but the last has a
  # learner reading.
  timed = learn_s[:-1]
  timed_steps = step_s[DIST_CHUNK - 1 - len(timed):DIST_CHUNK - 1]
  n = ts.obs.shape[0]
  summary = {
      'envs': n, 'env_steps': len(step_s),
      'trained_env_steps': len(learn_s),
      'train_steps': ts.learner.train_steps,
      'env_steps_per_s': n * len(timed_steps) / sum(timed_steps),
      'grad_steps_per_s': per_env_step * len(timed) / sum(timed),
      'ms_per_env_step': 1e3 * sum(timed_steps) / len(timed_steps),
      'learner_ms_per_env_step': 1e3 * sum(timed) / len(timed),
      'step_ms': [1e3 * s for s in step_s],
      'losses': losses,
      'peak_memory_gb': torch.cuda.max_memory_allocated() / 1e9}
  profile = {
      'device_ms': device_ms, 'launches': launches_per_step,
      'launches_per_train_step': launches_per_step / per_env_step,
      'nccl_kernels': sum(e.count for e in nccl),
      'nccl_device_ms': sum(e.self_device_time_total for e in nccl) / 1e3,
      'host_ms_by_part': {k: round(v, 3) for k, v in sorted(ranges.items())},
      'device_ms_by_part': {k: round(v, 3)
                            for k, v in sorted(device_ranges.items())},
      'allreduce_host_share_of_train_step':
          ranges[ALLREDUCE_LABEL] / ranges['learner: train step'],
      'allreduce_device_share': device_ranges[ALLREDUCE_LABEL] / device_ms}
  log(events.table(sort_by='self_cpu_time_total', row_limit=15,
                   max_name_column_width=60))
  grads = [p.grad for p in ts.learner.network.parameters()
           if p.requires_grad]
  profile['unprofiled'] = _allreduce_ms(
      grads, 'file://' + out_path + '.rendezvous')
  profile['unprofiled']['train_step_ms'] = (
      summary['learner_ms_per_env_step'] / per_env_step)
  params = env_lib.EnvParams(field_cache=True)
  out = {'launches': launches, 'summary': summary, 'profile': profile,
         'errs': {'physics_distributed': check_b1(params, ts.env_state),
                  'gp_window_distributed': check_b2(b2[0], 1, b2[1])},
         'timing': {}}
  if timing == 'timing':
    out['timing'] = {'physics_distributed': time_b1(params, ts.env_state),
                     'gp_window_distributed': time_b2(*b2)}
  with open(out_path, 'w') as f:
    json.dump(out, f)


def worker_gloo(out_dir: str, rank: str, init_method: str) -> None:
  """Part (b), rank `rank` of 2 on the one card over gloo: the trajectory
  run (GLOO_STEPS steps, the forced reset, GLOO_STEPS more), then the
  learning run with the learner's largest distance from the ranks' mean.
  Saves both to <out_dir>/rank_<rank>.pt."""
  import os
  import ble_tpu_torch  # noqa: F401
  from ble_tpu_torch.env import env as env_lib
  from ble_tpu_torch.parallel import distributed
  rank = int(rank)
  device = distributed.init_process_group(
      torch.device(DEV, 0), rank=rank, world_size=2,
      init_method=init_method, backend='gloo')
  try:
    params = env_lib.EnvParams(field_cache=True)
    seen = []
    field_fn = _recording(generative_field_fn(), seen)
    config = _gloo_config(2 * GLOO_E, learning=False)
    ts = distributed.init_distributed_train_state(0, config, params,
                                                  field_fn, device)
    ts, _ = distributed.build_distributed_step(config, params,
                                               GLOO_STEPS)(ts)
    lo, hi = distributed.shard_bounds(2 * GLOO_E, rank, 2)
    ts.active = ts.active & ~_forced(2 * GLOO_E)[lo:hi]
    ts, _ = distributed.build_distributed_reset(config, params,
                                                field_fn)(ts)
    ts, _ = distributed.build_distributed_step(config, params,
                                               GLOO_STEPS)(ts)
    result = {'snapshot': _gloo_snapshot(ts, seen)}

    config = _gloo_config(2 * GLOO_E, learning=True)
    ts = distributed.init_distributed_train_state(0, config, params,
                                                  field_fn, device)
    step = distributed.build_distributed_step(config, params,
                                              GLOO_LEARN_STEPS)
    ts, metrics = step(ts)
    deviation = 0.0
    for module in (ts.learner.network, ts.learner.target_network):
      for p in module.parameters():
        mean = p.detach().clone()
        torch.distributed.all_reduce(mean)
        deviation = max(deviation,
                        float((p.detach() - mean / 2).abs().max()))
    result['learning'] = {'deviation': deviation,
                          'train_steps': ts.learner.train_steps,
                          'collectives': step.allreduce.collectives,
                          'loss': metrics['loss'].cpu()}
    torch.save(result, os.path.join(out_dir, f'rank_{rank}.pt'))
  finally:
    torch.distributed.destroy_process_group()


def worker_tp(out_path: str, init_method: str) -> None:
  """Part (d): TP_STEPS steps of tensor_parallel.build_tp_train_step on a
  (1, 1) mesh over NCCL, on tests/test_tensor_parallel.py's batch."""
  import ble_tpu_torch  # noqa: F401
  from ble_tpu_torch.agents import qrdqn
  from ble_tpu_torch.parallel import distributed
  from ble_tpu_torch.parallel import tensor_parallel
  distributed.init_process_group(DEV, rank=0, world_size=1,
                                 init_method=init_method)
  try:
    mesh = tensor_parallel.make_2d_mesh(1, 1)
    config = qrdqn.QrDqnConfig(num_layers=4, hidden_units=64, num_atoms=11,
                               learning_rate=1e-3)
    init_fn, step_fn = tensor_parallel.build_tp_train_step(mesh, config, 32)
    state = init_fn(0)
    rng = np.random.RandomState(0)
    batch = {
        'obs': torch.tensor(rng.randn(16, 32), dtype=torch.float32),
        'action': torch.tensor(rng.randint(0, 3, 16), dtype=torch.int32),
        'n_step_reward': torch.tensor(rng.rand(16), dtype=torch.float32),
        'bootstrap_discount': torch.zeros(16),
        'next_obs': torch.tensor(rng.randn(16, 32), dtype=torch.float32),
        'weight': torch.ones(16)}
    losses = []
    for _ in range(TP_STEPS):
      state, metrics = step_fn(state, batch)
      losses.append(float(metrics['loss']))
    weight = state.network.layers[0].weight
    with open(out_path, 'w') as f:
      json.dump({'losses': losses, 'mesh': list(mesh.shape),
                 'placements': str(weight.placements),
                 'device': str(weight.device)}, f)
  finally:
    torch.distributed.destroy_process_group()


def worker_eval(steps: str, *cli_argv) -> None:
  """The eval CLI (`python -m ble_tpu_torch.train.eval`) with the suite's
  episodes cut to `steps` steps, for the script's time limit (phase api
  (b) runs a whole 960-step episode of the same CLI)."""
  from ble_tpu_torch.train import eval as eval_cli
  from ble_tpu_torch.train import suites
  get_eval_suite = suites.get_eval_suite
  suites.get_eval_suite = lambda name: suites.EvaluationSuite(
      get_eval_suite(name).seeds, int(steps))
  eval_cli.main(list(cli_argv))


WORKERS = {'train': worker_train, 'gloo': worker_gloo, 'tp': worker_tp,
           'eval': worker_eval}


def _learner_errs(got: dict, want: dict, start: dict) -> dict:
  """Phase train's card-vs-cpu readings for two state dicts of the same
  network: params (max |got - want| over max |want|) and updates (|got -
  want| over |want - start| in norm), the largest over the tensors; and
  whether every tensor is equal in bits."""
  errs = {'params': 0.0, 'updates': 0.0, 'same_bits': True}
  for k, w in want.items():
    g = got[k].to(w.device)
    errs['params'] = max(errs['params'], float(
        (g - w).abs().max() / w.abs().max()))
    delta = (w.double() - start[k].to(w.device)).norm()
    if delta > 0:
      errs['updates'] = max(errs['updates'], float(
          (g.double() - w.double()).norm() / delta))
    errs['same_bits'] &= bool(torch.equal(g, w))
  return errs


def dist_part_a(phases, base: str, work: str) -> dict:
  """Part (a): `distributed_train --n_devices 1` over E = TRAIN_E
  generative envs at TrainConfig's defaults, one chunk of DIST_CHUNK env
  steps with a checkpoint under `base` (worker_train); the CLI's JSON
  line (B1 and B2 every env step, train_steps 256 x the steps that could
  sample, one all-reduce a train step) and finite losses."""
  import os
  from ble_tpu_torch import config as config_lib
  from ble_tpu_torch.train import learner as learner_lib
  out_path = os.path.join(work, 'train.json')
  argv = ['--n_devices', '1', '--num_env_steps', str(DIST_CHUNK),
          '--chunk_steps', str(DIST_CHUNK), '--base_dir', base, '--seed',
          '0']
  for item in DIST_SETS:
    argv += ['--set', item]
  t = time.perf_counter()
  out = _run_workers([['train', out_path,
                       'timing' if 'timing' in phases else '-', *argv]])[0]
  worker_s = time.perf_counter() - t
  with open(out_path) as f:
    res = json.load(f)
  lines = [json.loads(line) for line in out.splitlines()
           if line.startswith('{"rank"')]
  check(len(lines) == 1, f'distributed CLI: {len(lines)} summary lines')
  cli = lines[0]
  config = config_lib.apply_overrides(learner_lib.TrainConfig(), DIST_SETS)
  first = (config.qrdqn.min_replay_history // config.num_envs +
           config.replay.n_step)
  trained = max(DIST_CHUNK - first, 0)
  check(cli['launches']['physics'] >= DIST_CHUNK and
        cli['launches']['gp_window'] >= DIST_CHUNK,
        f'distributed: B1 or B2 not launched every env step: {cli}')
  check(cli['launches'] == {k: res['launches'][k] for k in cli['launches']},
        'distributed: the CLI and the worker count other launches')
  check(cli['env_steps'] == DIST_CHUNK and cli['train_steps'] ==
        config.grad_steps_per_env_step() * trained,
        f'distributed: train_steps {cli["train_steps"]}')
  check(cli['allreduce_collectives'] == cli['train_steps'],
        'distributed: not one all-reduce a train step')
  losses = res['summary']['losses']
  check(all(np.isfinite(losses)) and all(l > 0 for l in losses[first:]),
        f'distributed: losses {losses}')
  res.update(cli=cli, worker_s=worker_s)
  return res


def dist_reference(params, field_fn, base: str, cli: dict) -> dict:
  """Part (a)'s learner (rank 0's checkpoint under `base`) against a
  single-process run_episode_chunk from the same seed, in this process,
  to phase train's card-vs-cpu limits; whether the bits are equal."""
  from ble_tpu_torch import config as config_lib
  from ble_tpu_torch.train import learner as learner_lib
  from ble_tpu_torch.train import train_lib
  config = config_lib.apply_overrides(learner_lib.TrainConfig(), DIST_SETS)
  t = time.perf_counter()
  ts = learner_lib.init_train_state(0, params, field_fn, config, DEV)
  start = {k: v.detach().double().clone()
           for k, v in ts.learner.network.state_dict().items()}
  ts, _ = learner_lib.selective_reset(ts, params, field_fn, config)
  ts, _ = learner_lib.run_episode_chunk(config, params, ts, DIST_CHUNK)
  torch.cuda.synchronize()
  reference_s = time.perf_counter() - t
  got, iteration = train_lib.restore_latest_learner_params(base)
  errs = _learner_errs(got, ts.learner.network.state_dict(), start)
  log(f'distributed (a): the learner of world 1 against the single-process '
      f'chunk: {json.dumps(errs)} (limits params {TRAIN_PARAM_RTOL}, '
      f'updates {TRAIN_UPDATE_RTOL}); reference run {reference_s:.1f} s')
  check(iteration == 1, f'distributed checkpoint iteration {iteration}')
  check(errs['params'] <= TRAIN_PARAM_RTOL and
        errs['updates'] <= TRAIN_UPDATE_RTOL,
        f'distributed: world 1 departs from run_episode_chunk: {errs}')
  check(ts.learner.train_steps == cli['train_steps'],
        'distributed: train_steps differ from the single process')
  return errs


def dist_part_b(params, field_fn, work: str) -> dict:
  """Part (b): two gloo ranks of GLOO_E envs on the one card against one
  process of 2 GLOO_E envs on it: observations, pressure, replay rows,
  counters and every reset's world seeds equal in bits across the forced
  reset, and a seed's decoded field whatever its batch; then with
  learning on every parameter within 1e-6 of the ranks' mean
  (tests/test_training.py:555-556) and one all-reduce a train step."""
  import os
  from ble_tpu_torch.env import env as env_lib
  from ble_tpu_torch.train import learner as learner_lib
  ranks = [torch.load(os.path.join(work, f'rank_{r}.pt'), weights_only=False)
           for r in range(2)]
  seen = []
  recorded = _recording(field_fn, seen)
  config = _gloo_config(2 * GLOO_E, learning=False)
  ts = learner_lib.init_train_state(0, params, recorded, config, DEV)
  ts, _ = learner_lib.run_episode_chunk(config, params, ts, GLOO_STEPS)
  ts.active = ts.active & ~_forced(2 * GLOO_E)
  ts, _ = learner_lib.selective_reset(ts, params, recorded, config)
  ts, _ = learner_lib.run_episode_chunk(config, params, ts, GLOO_STEPS)
  want = _gloo_snapshot(ts, seen)
  got = [r['snapshot'] for r in ranks]
  pairs = {k: (torch.cat([got[0][k], got[1][k]]), want[k])
           for k in ('obs', 'pressure')}
  pairs.update({f'replay.{k}': (torch.cat([got[0]['replay'][k],
                                           got[1]['replay'][k]]), v)
                for k, v in want['replay'].items()})
  same = {k: torch.equal(a, b) for k, (a, b) in pairs.items()}
  # Where the bits differ: the largest difference and the envs it is in.
  apart = {k: {'max_abs': float((a.double() - b.double()).abs().max()),
               'envs': int((a != b).reshape(a.shape[0], -1).any(1).sum())}
           for k, (a, b) in pairs.items() if not same[k]}
  same['seeds'] = all(want['seeds'][i] == got[0]['seeds'][i] +
                      got[1]['seeds'][i] for i in range(2))
  same['counters'] = all(g['counters'] == want['counters'] for g in got)
  # A seed's decoded field whatever the seeds decoded beside it
  # (env.DECODE_BLOCK): 2 GLOO_E seeds at once against two calls.
  keys = env_lib.forecast_keys(env_lib.seed_keys(range(2 * GLOO_E)))
  fields = field_fn(keys, DEV)
  for split in (GLOO_E, 2 * GLOO_E // 10 + 1):
    same[f'decode {split} + {2 * GLOO_E - split}'] = torch.equal(
        fields, torch.cat([field_fn(keys[:split], DEV),
                           field_fn(keys[split:], DEV)]))
  learning = [r['learning'] for r in ranks]
  log('distributed (b): two gloo ranks against one process, equal in bits:',
      json.dumps(same), '; where not:', json.dumps(apart), '; learning:',
      json.dumps([{k: v for k, v in l.items() if k != 'loss'}
                  for l in learning]))
  check(all(same.values()), f'distributed (b): the ranks depart: {same}')
  for l in learning:
    check(l['train_steps'] > 0 and l['deviation'] <= 1e-6 and
          l['collectives'] == l['train_steps'] and
          bool(torch.isfinite(l['loss']).all()),
          f'distributed (b): learner not replicated: {l}')
  return {'same': same, 'deviation': max(l['deviation'] for l in learning)}


def dist_part_c(params, field_fn, work: str) -> None:
  """Part (c): eval_lib on the card, SHARD_SEEDS seeds for SHARD_STEPS
  StationSeeker steps: the two slices of --num_shards 2, written and
  merged by combine_shard_results, equal to the unsharded run seed for
  seed (no reduction crosses the env axis)."""
  import os
  from ble_tpu_torch.train import eval_lib
  eval_fn = eval_lib.build_eval_fn(params, field_fn, *policy(),
                                   max_steps=SHARD_STEPS, device=DEV)
  seeds = list(range(SHARD_SEEDS))
  whole = [dataclasses.asdict(r) for r in eval_lib.evaluate(eval_fn, seeds)]
  paths = []
  for idx in range(2):
    paths.append(os.path.join(work, f'shard_{idx}.json'))
    eval_lib.write_results_json(eval_lib.evaluate(eval_fn, seeds[idx::2]),
                                paths[-1])
  combined = eval_lib.combine_shard_results(paths)
  differ = [a['seed'] for a, b in zip(combined, whole) if a != b]
  log(f'distributed (c): {SHARD_SEEDS} seeds x {SHARD_STEPS} steps, two '
      f'shards combined against the unsharded run: seeds that differ '
      f'{differ}')
  check(len(combined) == len(whole) and not differ,
        f'distributed (c): sharded eval differs at seeds {differ}')


def dist_part_d(work: str) -> None:
  """Part (d): the tensor-parallel demo at a (1, 1) mesh on NCCL (its
  worker's output): TP_STEPS finite, falling losses."""
  import os
  with open(os.path.join(work, 'tp.json')) as f:
    tp = json.load(f)
  log('distributed (d): tensor-parallel demo', json.dumps(tp))
  losses = tp['losses']
  check(len(losses) == TP_STEPS and all(np.isfinite(losses)) and
        losses[-1] < losses[0], f'distributed (d): losses {losses}')


def phase_distributed(params, field_fn, phases, train_summary) -> dict:
  """Parts (a) to (d) (DIST_CHUNK's note), each process group in worker
  processes that end with their part. Part (a)'s worker runs alone, as it
  is timed; then the eval CLI on its checkpoint runs beside the checks
  that time nothing: the single-process reference, parts (b) and (d)
  (their three workers at once) and (c). Prints world 1's env-steps/s,
  gradient steps/s and the all-reduce's share of a train step beside
  phase train's, and returns the rows' launches, errors and times."""
  import os
  import tempfile
  t0 = time.perf_counter()
  with tempfile.TemporaryDirectory() as work:
    base = os.path.join(work, 'run')
    a = dist_part_a(phases, base, work)
    eval_dir = os.path.join(work, 'eval')
    t_eval = time.perf_counter()
    evaluation = [_start([sys.executable, os.path.abspath(__file__),
                          '--worker', 'eval', str(AGENTS_EVAL_STEPS),
                          '--agent', 'quantile', '--checkpoint_dir', base,
                          '--suite', 'micro_eval', '--output_dir',
                          eval_dir])]
    try:
      a['learner_errs'] = dist_reference(params, field_fn, base, a['cli'])
      t = time.perf_counter()
      gloo = 'file://' + os.path.join(work, 'gloo_rendezvous')
      _run_workers([['gloo', work, str(r), gloo] for r in range(2)] + [
          ['tp', os.path.join(work, 'tp.json'),
           'file://' + os.path.join(work, 'tp_rendezvous')]])
      b = dist_part_b(params, field_fn, work)
      dist_part_d(work)
      b_d_s = time.perf_counter() - t
      t = time.perf_counter()
      dist_part_c(params, field_fn, work)
      c_s = time.perf_counter() - t
    except BaseException:
      _stop(evaluation)
      raise
    _finish(evaluation)
    eval_s = time.perf_counter() - t_eval
    with open(os.path.join(eval_dir, 'quantile_micro_eval.json')) as f:
      results = json.load(f)['results']
    check(len(results) == 1 and
          0 < results[0]['final_timestep'] <= AGENTS_EVAL_STEPS and
          0.0 <= results[0]['time_within_radius'] <= 1.0 and
          np.isfinite(results[0]['cumulative_reward']),
          f'distributed: eval of the checkpoint {results}')
    log(f'distributed (a): eval CLI on the checkpoint, micro_eval (cut to '
        f'{AGENTS_EVAL_STEPS} steps), done {eval_s:.1f} s after its start: '
        f'{json.dumps(results[0])}')
  s, p = a['summary'], a['profile']
  u = p['unprofiled']
  report = {
      'world1_env_steps_per_s': s['env_steps_per_s'],
      'world1_grad_steps_per_s': s['grad_steps_per_s'],
      'world1_ms_per_env_step': s['ms_per_env_step'],
      'world1_learner_ms_per_env_step': s['learner_ms_per_env_step'],
      'allreduce_host_share_of_train_step':
          p['allreduce_host_share_of_train_step'],
      'allreduce_device_share': p['allreduce_device_share'],
      'nccl_kernels_in_profiled_step': p['nccl_kernels'],
      'allreduce_unprofiled_ms': u['flat_ms'],
      'allreduce_unprofiled_share_of_train_step':
          u['flat_ms'] / u['train_step_ms'],
      'per_tensor_allreduce_unprofiled_ms': u['per_tensor_ms'],
      'profiled_device_ms': p['device_ms'],
      'launches_per_train_step': p['launches_per_train_step'],
      'learner_same_bits_as_single_process': a['learner_errs']['same_bits'],
      'gloo_max_deviation': b['deviation'],
      'seconds': {'a_worker': a['worker_s'], 'a_eval_beside_b_c_d': eval_s,
                  'b_d': b_d_s, 'c': c_s,
                  'phase': time.perf_counter() - t0}}
  if train_summary is not None:
    report['train_env_steps_per_s'] = train_summary['env_steps_per_s']
    report['train_split_env_steps_per_s'] = (
        train_summary['split_env_steps_per_s'])
    report['train_split_grad_steps_per_s'] = (
        train_summary['split_grad_steps_per_s'])
    report['ratio_to_train'] = (s['env_steps_per_s'] /
                                train_summary['env_steps_per_s'])
    report['ratio_to_train_split'] = (
        s['env_steps_per_s'] / train_summary['split_env_steps_per_s'])
  log(f'distributed: {nvidia_smi_line()}:', json.dumps(report))
  log('distributed: profile of the chunk\'s last env step:',
      json.dumps(p))
  return {'launches': {
      'physics_distributed': a['cli']['launches']['physics'],
      'gp_window_distributed': a['cli']['launches']['gp_window']},
          'errs': a['errs'], 'timing': a['timing']}


# ---------------------------------------------------------------- VAE -----

# Phase vae: the wind VAE's trainer at full width (88 M parameters). Its
# products are cuBLAS GEMMs and its optimizer torch.optim.Adam: the JAX
# package trains it outside any Pallas kernel, so no kernel of the port
# runs on this path.
VAE_BATCH = 16
# (b): the JAX package's 3-step seed-0 run on its synthetic reservoir
# (tests/torch_jax_vae.json, written by tests/test_torch_vae_train.py).
# Each metric within VAE_FIXTURE_RTOL relative: XLA's float32 sum over a
# grid's 79,380 squared errors reads up to ~4e-5 from the exact sum (the
# port's ~4e-8), which the MSE, the loss and the evaluation's MSE carry.
VAE_FIXTURE = 'tests/torch_jax_vae.json'
VAE_FIXTURE_RUN = {'seed': 0, 'batches': 3, 'batch_size': 2}
VAE_FIXTURE_RTOL = 1e-4
# (c): the CLI's run, at its default batch of 16.
VAE_CLI_BATCHES = 20
# (a): one train step card vs CPU from (b)'s parameters and a fresh Adam,
# read as phase train's (_train_step_errs), held to these limits and the
# loss to 1e-5. Phase train's params and updates limits (1e-5, 1e-3) do
# not fit this step: Adam's first step is ~lr * sign(g) for every element,
# and a gradient element within its rounding of zero takes another sign on
# the card than on the CPU. (b)'s biases are ~3 steps (3e-4) large, so one
# such element moves a tensor's max |card - cpu| / max |cpu| to ~0.02. On
# an H100 (80GB HBM3, 700 W) the sound step read params 0.0233, grads
# 1.1e-6, updates 1.2e-3 and 2.0e-3 in two calls; the TF32 step 0.50,
# 0.040, 0.25; the step at 1.1 times the rate 0.025, 1.1e-6, 0.100.
VAE_STEP_LIMITS = {'params': 0.1, 'grads': TRAIN_GRAD_RTOL, 'updates': 1e-2}
# (d): unprofiled steps timed after VAE_WARMUP, then profiled ones.
VAE_WARMUP = 3
VAE_TIMED_STEPS = 30
VAE_PROFILED_STEPS = 5


@contextlib.contextmanager
def _recording_vae_trainer(rec: dict):
  """Inside the block, every train step that train_vae.make_train_step
  makes appends its metrics to rec['steps'] and train_vae.evaluate puts
  its metrics in rec['eval'], each as floats."""
  from ble_tpu_torch.generative import train_vae
  make_train_step, evaluate = train_vae.make_train_step, train_vae.evaluate

  def recording_make_train_step(model, optimizer):
    step = make_train_step(model, optimizer)

    def recording_step(*args):
      out = step(*args)
      rec.setdefault('steps', []).append(
          {k: float(v) for k, v in out.items()})
      return out
    return recording_step

  def recording_evaluate(*args):
    out = evaluate(*args)
    rec['eval'] = {k: float(v) for k, v in out.items()}
    return out

  train_vae.make_train_step = recording_make_train_step
  train_vae.evaluate = recording_evaluate
  try:
    yield
  finally:
    train_vae.make_train_step, train_vae.evaluate = make_train_step, evaluate


def vae_fixture_run(device) -> dict:
  """train_vae.train on the synthetic reservoir at VAE_FIXTURE_RUN (one
  epoch) on `device`: each step's metrics, the evaluation's, the epoch's
  printed line and the trained model."""
  import io
  from ble_tpu_torch.generative import reservoir
  from ble_tpu_torch.generative import train_vae
  run = VAE_FIXTURE_RUN
  rec = {}
  out = io.StringIO()
  with _recording_vae_trainer(rec), contextlib.redirect_stdout(out):
    rec['model'] = train_vae.train(
        reservoir.SyntheticWindFieldReservoir(run['seed'], device=device),
        num_epochs=1, batches_per_epoch=run['batches'],
        batch_size=run['batch_size'], seed=run['seed'], device=device)
  rec['line'] = out.getvalue().strip()
  return rec


def compare_vae_run(got: dict, want: dict) -> list:
  """What of vae_fixture_run's `got` lies further than VAE_FIXTURE_RTOL
  from the fixture `want`, one line each."""
  bad = []
  if want['run'] != VAE_FIXTURE_RUN or len(got['steps']) != len(
      want['steps']):
    return [f'run {want["run"]} with {len(want["steps"])} steps, '
            f'{len(got["steps"])} run']
  labelled = [(f'step {i}', g, w) for i, (g, w) in
              enumerate(zip(got['steps'], want['steps']))]
  for label, g, w in labelled + [('eval', got['eval'], want['eval'])]:
    for key, value in w.items():
      err = abs(g[key] - value) / abs(value)
      if not err <= VAE_FIXTURE_RTOL:
        bad.append(f'{label} {key}: {g[key]} vs {value} (relative {err:.3g})')
  return bad


def _vae_step_errs(model, cpu, before) -> dict:
  """_train_step_errs for the VAE's parameters."""
  return _train_step_errs(types.SimpleNamespace(network=model),
                          types.SimpleNamespace(network=cpu), before)


def check_vae_train_step(state: dict) -> dict:
  """One full-width train step at batch VAE_BATCH on the card against the
  same step on the CPU, from the parameters `state`, a fresh Adam, one
  synthetic batch and one noise key: params, grads and updates to
  VAE_STEP_LIMITS, the loss to 1e-5 relative; then the TF32 and 1.1 x rate
  controls, each of which must break one. All readings are logged before
  any is checked. Returns them."""
  from ble_tpu_torch.generative import reservoir
  from ble_tpu_torch.generative import train_vae
  from ble_tpu_torch.generative import vae
  from ble_tpu_torch.utils import prng
  batch = reservoir.SyntheticWindFieldReservoir(
      0, device='cpu').get_batch(VAE_BATCH, prng.key(1))
  key, kl_weight, lr = prng.key(2), 512.0, 1e-4
  before = {k: v.detach().cpu().double() for k, v in state.items()}

  def step(device, rate=lr):
    model = vae.make_vae(state, device)
    out = train_vae.make_train_step(
        model, train_vae.make_optimizer(model, rate))(batch.to(device), key,
                                                      kl_weight)
    return model, out

  cpu, cpu_m = step('cpu')
  card, card_m = step(DEV)
  errs = _vae_step_errs(card, cpu, before)
  loss_err = abs(float(card_m['loss']) - float(cpu_m['loss'])) / abs(
      float(cpu_m['loss']))
  errs['loss'] = loss_err
  log(f'vae (a): one train step at batch {VAE_BATCH}, card vs cpu, max over '
      f'tensors of relative |card - cpu|: {json.dumps(errs)}; loss '
      f'{float(card_m["loss"]):.9g} vs {float(cpu_m["loss"]):.9g}')
  del card
  controls = {}
  with _tf32(matmul=True, cudnn=True):
    controls['tf32'] = _vae_step_errs(step(DEV)[0], cpu, before)
  controls['lr x 1.1'] = _vae_step_errs(step(DEV, 1.1 * lr)[0], cpu, before)
  log('vae (a): controls, faulty steps on the card vs the sound cpu step:',
      json.dumps(controls))
  for name, limit in VAE_STEP_LIMITS.items():
    check(errs[name] <= limit, f'vae train step {name} {errs[name]} > {limit}')
  check(loss_err <= 1e-5, f'vae train step loss {loss_err}')
  for control, ctrl in controls.items():
    check(any(ctrl[k] > limit for k, limit in VAE_STEP_LIMITS.items()),
          f'the vae train-step limits pass the {control} control: {ctrl}')
  return {'errs': errs, 'controls': controls}


def _parse_epoch_line(out: str) -> dict:
  """The metrics of the last `epoch <n>: k=v ...` line of `out`."""
  lines = [l for l in out.splitlines() if l.startswith('epoch ')]
  check(bool(lines), f'vae (c): no epoch line in {out!r}')
  return {k: float(v) for k, v in
          (item.split('=') for item in lines[-1].split(': ', 1)[1].split())}


def check_vae_checkpoint(path: str, printed: dict) -> None:
  """The CLI's checkpoint: read back onto the card, the module's state
  equal in bits to the file's; the evaluation train() printed, recomputed
  from it with the same key chain, within the line's 4 decimals (and 1e-6
  relative); its decoder loaded into vae.Decoder decodes what the VAE's
  generate does, in bits."""
  from ble_tpu_torch.generative import reservoir
  from ble_tpu_torch.generative import train_vae
  from ble_tpu_torch.generative import vae
  from ble_tpu_torch.utils import prng
  state = torch.load(path, map_location='cpu', weights_only=True)
  model = vae.make_vae(state, DEV)
  check(set(model.state_dict()) == set(state) and all(
      torch.equal(v.cpu(), state[k]) for k, v in model.state_dict().items()),
        'vae (c): the checkpoint does not read back in bits')
  key = prng.key(0)
  _, key = prng.split(key)
  for _ in range(VAE_CLI_BATCHES):
    key = prng.split(key, 3)[0]
  eval_key = prng.split(key)[1]
  fields = reservoir.SyntheticWindFieldReservoir(
      device=DEV).get_eval_batch(VAE_BATCH)
  got = {k: float(v) for k, v in
         train_vae.evaluate(model, fields, eval_key).items()}
  for name, value in got.items():
    check(abs(value - printed[name]) <= 5e-5 + 1e-6 * abs(value),
          f'vae (c): {name} from the checkpoint {value}, printed '
          f'{printed[name]}')
  decoder = vae.Decoder()
  decoder.load_state_dict({k[len('decoder.'):]: v for k, v in state.items()
                           if k.startswith('decoder.')})
  decoder = decoder.to(DEV)
  z = prng.normal(prng.key(9), (VAE_BATCH, vae.NUM_LATENTS)).to(DEV)
  with torch.no_grad():
    grids = decoder(z)
    check(grids.shape == (VAE_BATCH, 21, 21, 10, 9, 2) and
          bool(torch.isfinite(grids).all()) and
          torch.equal(grids, model.generate(z)),
          'vae (c): the checkpoint\'s decoder')
  log(f'vae (c): checkpoint read back; evaluation from it {json.dumps(got)}')


def time_vae(state: dict) -> dict:
  """Train steps at batch VAE_BATCH on the card from `state`: unprofiled
  steps/s on one fixed batch (the step alone) and through train()'s loop
  body (the keys' splits and the synthetic reservoir's draw included),
  then device ms, launches and busy share of a step under torch.profiler
  with its top kernels (name, launches and ms a step), and the peak memory
  of the steps."""
  from ble_tpu_torch.generative import reservoir
  from ble_tpu_torch.generative import train_vae
  from ble_tpu_torch.generative import vae
  from ble_tpu_torch.utils import prng
  torch.cuda.reset_peak_memory_stats()
  model = vae.make_vae(state, DEV)
  step = train_vae.make_train_step(model, train_vae.make_optimizer(model,
                                                                   1e-4))
  res = reservoir.SyntheticWindFieldReservoir(device=DEV)
  batch, key = res.get_batch(VAE_BATCH, prng.key(1)), prng.key(2)

  def fixed(n):
    for _ in range(n):
      step(batch, key, 512.0)
    torch.cuda.synchronize()

  keys = [prng.key(3)]

  def loop(n):
    for _ in range(n):
      keys[0], batch_key, step_key = prng.split(keys[0], 3)
      step(res.get_batch(VAE_BATCH, batch_key), step_key, 512.0)
    torch.cuda.synchronize()

  out = {}
  for name, fn in (('step', fixed), ('loop', loop)):
    fn(VAE_WARMUP)
    t = time.perf_counter()
    fn(VAE_TIMED_STEPS)
    out[f'{name}_ms'] = 1e3 * (time.perf_counter() - t) / VAE_TIMED_STEPS
    out[f'{name}_steps_per_s'] = 1e3 / out[f'{name}_ms']
  from torch.autograd import DeviceType
  device_ms, launches, events = device_time(
      lambda: fixed(VAE_PROFILED_STEPS), VAE_PROFILED_STEPS)
  kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                    and not e.is_user_annotation),
                   key=lambda e: -e.self_device_time_total)
  out['top_kernels_ms_per_step'] = [
      [e.key[:160], e.count / VAE_PROFILED_STEPS,
       e.self_device_time_total / 1e3 / VAE_PROFILED_STEPS]
      for e in kernels[:8]]
  out.update({'device_ms_per_step': device_ms,
              'launches_per_step': launches,
              'busy_share': device_ms / out['step_ms'],
              'peak_memory_gb': torch.cuda.max_memory_allocated() / 1e9})
  return out


def phase_vae() -> dict:
  """The wind VAE's training path at full width (VAE_BATCH's note): (c)
  the CLI, `python -m ble_tpu_torch.generative.train_vae --synthetic
  --epochs 1 --batches_per_epoch VAE_CLI_BATCHES --checkpoint_dir <tmp>`
  (no --device: the card), started first and run beside (b) and (a); (b)
  the 3-step seed-0 run on the card against the JAX package's values; (a)
  one train step at batch VAE_BATCH, card against CPU, from (b)'s trained
  parameters; then (c)'s output (exit 0, finite metrics) and checkpoint;
  (d) the timing, alone on the card. Returns (d)'s numbers."""
  import os
  import tempfile
  t0 = time.perf_counter()
  with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         VAE_FIXTURE)) as f:
    fixture = json.load(f)
  with tempfile.TemporaryDirectory() as work:
    cli = [_start([sys.executable, '-m',
                   'ble_tpu_torch.generative.train_vae', '--synthetic',
                   '--epochs', '1', '--batches_per_epoch',
                   str(VAE_CLI_BATCHES), '--checkpoint_dir', work])]
    try:
      t = time.perf_counter()
      run = vae_fixture_run(DEV)
      log(f'vae (b): {run["line"]}')
      check(run['model'].sigma.device.type == 'cuda', 'vae (b): not on card')
      bad = compare_vae_run(run, fixture)
      worst = max(abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(
          run['steps'] + [run['eval']], fixture['steps'] + [fixture['eval']])
                  for k in w)
      log(f'vae (b): card vs the JAX package, largest relative error '
          f'{worst:.3g} (limit {VAE_FIXTURE_RTOL}), '
          f'{time.perf_counter() - t:.1f} s')
      check(not bad, f'vae (b): {bad}')
      state = {k: v.cpu() for k, v in run['model'].state_dict().items()}
      del run
      step_check = check_vae_train_step(state)
    except BaseException:
      _stop(cli)
      raise
    printed = _parse_epoch_line(_finish(cli)[0])
    check(all(np.isfinite(v) for v in printed.values()) and
          set(printed) == {'kld', 'loss', 'mse', 'sigma', 'data_mean_speed',
                           'eval_kld', 'eval_mse', 'gen_mean_speed'},
          f'vae (c): epoch metrics {printed}')
    check_vae_checkpoint(os.path.join(work, 'vae_0.pt'), printed)
  timing = time_vae(state)
  timing['seconds'] = time.perf_counter() - t0
  log(f'vae (d): {nvidia_smi_line()}:', json.dumps(timing))
  return {'timing': timing, **step_check}


def time_b1(params, state) -> dict:
  """B1 at the batch of `state` with random actions."""
  from ble_tpu_torch.env import balloon as balloon_lib
  from ble_tpu_torch.ops import cuda_build
  from ble_tpu_torch.ops import physics
  b, act, bufs = b1_inputs(params, state)
  f32_out, i32_out = torch.empty_like(bufs[0]), torch.empty_like(bufs[1])
  params_c = physics.uniform_params(params.balloon)
  ms = cuda_ms(lambda: physics.launch(*bufs, f32_out, i32_out, 18, 10,
                                      params_c), reps=50)
  plain_ms = cuda_ms(lambda: balloon_lib.run_substeps(
      params.balloon, state.atmosphere, b, state.wind_u, state.wind_v, act,
      18, 10), reps=3, warmup=1)
  # Work this run's data needs: the substeps each env really ran.
  elapsed0 = bufs[1][1]
  elapsed1 = i32_out[1]
  substeps = float(((elapsed1 - elapsed0) // 10).sum())
  by_class = b1_ops_ms(substeps)
  nbytes = 4.0 * b.x_m.shape[0] * (16 + 3 + 23 + 2 + 1 + 16 + 3)
  row = _bound_row(ms, plain_ms, None, max(by_class.values()), nbytes)
  row['device_ms'] = kernel_device_ms(lambda: physics.launch(
      *bufs, f32_out, i32_out, 18, 10, params_c))
  row['ops_ms_by_class'] = by_class
  row['substeps_run'] = substeps
  row['envs_per_cta'] = physics.env_split(b.x_m.shape[0],
                                          cuda_build.sm_count(0))
  return row


def time_b5(gp_state, xs, ys, ts) -> dict:
  """B5 at the batch of `gp_state` and the 181 feature levels, each env's
  column at its (x, y, t). The library yardstick: one batched float32
  matmul of k* by kinv, its dominant term (never called by the port)."""
  from ble_tpu_torch.ops import cuda_build
  from ble_tpu_torch.ops import gp_query
  from ble_tpu_torch.ops import gp_window
  args = gp_query.pack(gp_state, xs, ys, ts, gp_window.pressure_levels(DEV))
  n = xs.shape[0]
  ms = cuda_ms(lambda: gp_query.launch(*args), reps=20)
  plain_ms = cuda_ms(lambda: gp_query.query_plain(*args), reps=5)
  k_star = torch.rand((n, 181, 128), device=DEV)
  kinv = args[3]
  library_ms = cuda_ms(lambda: torch.bmm(k_star, kinv), reps=20)
  row = _bound_row(ms, plain_ms, library_ms,
                   1e3 * n * query_ops(181) / PEAK_F32_FLOPS,
                   query_bytes(n, 181))
  row['device_ms'] = kernel_device_ms(lambda: gp_query.launch(*args))
  row['library_device_ms'] = kernel_device_ms(lambda: torch.bmm(k_star, kinv))
  row['slices'] = gp_query.level_split(n, 181, cuda_build.sm_count(0))
  if n > 1:
    row.update(clock_under_load(lambda: gp_query.launch(*args)))
  return row


def time_b2(gp_state, obs=None) -> dict:
  """B2 at the batch of `gp_state` over the K steps of `obs` (by default
  one step of gp_obs_seq's), beside its plain version, the library
  yardstick and its bound (the query at every step, the observe at every
  enabled step, kinv read and written once a launch); the SM clock under
  load."""
  from ble_tpu_torch.ops import gp_window
  n = gp_state.kinv.shape[0]
  if obs is None:
    obs = gp_obs_seq(2, 1, n, t0_step=140)
  f32 = lambda a: a.to(torch.float32).contiguous()
  args = (obs, f32(gp_state.locations), f32(gp_state.errors),
          f32(gp_state.active), f32(gp_state.kinv), f32(gp_state.alpha),
          gp_state.count.to(torch.int32).contiguous())
  ms = cuda_ms(lambda: gp_window.launch(*args), reps=20)
  plain_ms = cuda_ms(lambda: gp_window.window_plain(gp_state, obs), reps=3,
                     warmup=1)
  # The library yardstick: K batched float32 matmuls of kinv by k*, the
  # kernel's dominant term at each of its K steps (never called by the
  # port).
  k_star = torch.rand((n, 128, 181), device=DEV)
  library = lambda: [torch.bmm(gp_state.kinv, k_star)
                     for _ in range(obs.shape[0])]
  library_ms = cuda_ms(library, reps=20)
  row = _bound_row(ms, plain_ms, library_ms,
                   1e3 * b2_ops(obs) / PEAK_F32_FLOPS, b2_bytes(obs))
  row['device_ms'] = kernel_device_ms(lambda: gp_window.launch(*args))
  row['library_device_ms'] = kernel_device_ms(library)
  row['steps'] = obs.shape[0]
  row.update(clock_under_load(lambda: gp_window.launch(*args)))
  return row


def phase_timing(params, state, gp_state, gym_state, train_state,
                 train_b2, window_out, agents_out=None,
                 api: bool = False, params_out=None) -> dict:
  """Each kernel at the batch of the path its launches are counted on:
  B1 and B2 at E = 4096 (main); B1 on the window run's final state and B2
  at K = 8 on its last window's GP state and observations, E = 4096
  (window); B1 and B5 on the gym run's final state
  and B3 on a GP state warmed past the ring, E = 1 (gym); B4 and B5 at
  E = 4096 (pair); B1 on the train run's final env state and B2 on the
  train run's own GP state and observations, E = 1024 (train); the same
  on the r2d2 run of phase agents, E = 1024 (agents); B5 on the main
  path's reset state, E = 4096 (api); B1 on the params run's final state
  and B2 on its last step's GP state and observations, E = 4096
  (params)."""
  out = {'physics': time_b1(params, state)}
  if api:
    b = state.balloon
    out['gp_query_api'] = time_b5(state.gp, b.x_m, b.y_m, b.time_elapsed_s)
  if params_out is not None:
    out['physics_params'] = time_b1(params, params_out['state'])
    out['gp_window_params'] = time_b2(*params_out['b2'])
  if window_out is not None:
    out['physics_window'] = time_b1(params, window_out['state'])
    out['gp_window_window'] = time_b2(*window_out['b2'])
  if train_state is not None:
    out['physics_train'] = time_b1(params, train_state.env_state)
    out['gp_window_train'] = time_b2(*train_b2)
  if agents_out is not None:
    out['physics_agents'] = time_b1(params, agents_out['state'])
    out['gp_window_agents'] = time_b2(*agents_out['b2'])
  if gym_state is not None:
    b = gym_state.balloon
    out['physics_gym'] = time_b1(params, gym_state)
    out['gp_query_gym'] = time_b5(gym_state.gp, b.x_m, b.y_m,
                                  b.time_elapsed_s)

  out['gp_window'] = time_b2(gp_state)
  obs = gp_obs_seq(2, 1, E, t0_step=140)
  f32 = lambda a: a.to(torch.float32).contiguous()

  # B3 (E = 1) and B4 (E = 4096): the observe alone. The library yardstick
  # is one batched float32 baddbmm of its rank-8 update, kinv + (W c) W^T,
  # its only full read and write of kinv (never called by the port).
  from ble_tpu_torch.ops import cuda_build
  from ble_tpu_torch.ops import gp_observe
  state1, obs1 = gp_track_state(1, 140, seed=5)
  for name, st, ob in (('gp_observe_b3', state1, obs1),
                       ('gp_observe_b4', gp_state, obs[0])):
    n = ob.shape[0]
    args = (ob, f32(st.locations), f32(st.errors), f32(st.active),
            f32(st.kinv), f32(st.alpha), st.count.to(torch.int32).contiguous())
    ms = cuda_ms(lambda: gp_observe.launch(*args), reps=50)
    plain_ms = cuda_ms(lambda: gp_observe.observe_plain(st, ob), reps=5)
    w = torch.rand((n, 128, 8), device=DEV)
    library = lambda: torch.baddbmm(st.kinv, w, w.transpose(1, 2))
    library_ms = cuda_ms(library, reps=20)
    enabled = float((ob[:, 6] > 0.5).sum())
    out[name] = _bound_row(ms, plain_ms, library_ms,
                           1e3 * enabled * OBSERVE_OPS / PEAK_F32_FLOPS,
                           observe_bytes(n))
    out[name]['device_ms'] = kernel_device_ms(
        lambda: gp_observe.launch(*args))
    out[name]['library_device_ms'] = kernel_device_ms(library)
    out[name]['split'] = gp_observe.observe_split(n, cuda_build.sm_count(0))

  out['gp_query_pair'] = time_b5(gp_state, obs[0, :, 0], obs[0, :, 1],
                                 obs[0, :, 3])
  return out


def _bound_row(ms, plain_ms, library_ms, ops_ms, nbytes) -> dict:
  bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
  return {'ms': ms, 'plain_ms': plain_ms, 'library_ms': library_ms,
          'bound_ms': max(ops_ms, bytes_ms),
          'bound_by': 'operations' if ops_ms >= bytes_ms else 'bytes',
          'ops_ms': ops_ms, 'bytes_ms': bytes_ms}


def _step_ranges():
  """The parts of a main-path step in torch.profiler ranges."""
  from ble_tpu_torch.agents import station_seeker
  from ble_tpu_torch.env import balloon as balloon_lib
  from ble_tpu_torch.env import env as env_lib
  from ble_tpu_torch.env import features
  from ble_tpu_torch.env import pressure_range
  from ble_tpu_torch.env import wind_gp
  from ble_tpu_torch.ops import gp_window
  from ble_tpu_torch.ops import physics
  return _ranges([
      (physics, 'simulate_step_fused', 'physics (B1 + safety)'),
      (env_lib, '_wind_and_forecast', 'wind column + noise'),
      (gp_window, 'step', 'gp (B2)'),
      (features, 'ambient_features', 'features: ambient'),
      (pressure_range, 'compute_pressure_range', 'features: pressure range'),
      (features, 'wind_column_features_precomputed', 'features: wind column'),
      (balloon_lib, 'excess_energy', 'excess energy'),
      (station_seeker, 'pick_action', 'policy'),
      (wind_gp, 'refresh', 'gp refresh (every 64)'),
      (env_lib, 'refresh_field_cache', 'slab re-centre (every 8)'),
  ])


def _train_ranges():
  """The parts of a training env step in torch.profiler ranges: the env
  step, the actor's parts, and the learner's, with each train step's loss
  (both networks' forwards) inside it; backward and Adam are the train
  step less its loss."""
  from ble_tpu_torch.agents import marco_polo
  from ble_tpu_torch.agents import qrdqn
  from ble_tpu_torch.agents import replay
  from ble_tpu_torch.env import env as env_lib
  from ble_tpu_torch.train import learner as learner_lib
  return _ranges([
      (env_lib, 'step_batched', 'env step (B1, B2)'),
      (qrdqn, 'select_action', 'policy'),
      (marco_polo, 'step', 'marco polo'),
      (replay, 'add', 'replay add'),
      (learner_lib, 'learn', 'learner'),
      (replay, 'sample', 'learner: replay sample'),
      (qrdqn, 'train_step', 'learner: train step'),
      (qrdqn, 'quantile_loss', 'learner: train step: loss'),
  ])


@contextlib.contextmanager
def _ranges(targets):
  """Wraps each (module, attribute, label) of `targets` in a
  torch.profiler range named step/<label>, by patching the module
  attributes the path calls through; the port itself carries no
  instrumentation."""
  saved = []
  for module, name, label in targets:
    fn = getattr(module, name)
    saved.append((module, name, fn))

    def wrapped(*args, _fn=fn, _label=label, **kwargs):
      with torch.profiler.record_function(f'step/{_label}'):
        return _fn(*args, **kwargs)

    setattr(module, name, wrapped)
  try:
    yield
  finally:
    for module, name, fn in saved:
      setattr(module, name, fn)


def phase_profile(params, field_fn, state0, obs0) -> None:
  """torch.profiler over 16 main-path steps, after an unprofiled run of
  the same 16 steps that gives the step's wall time without the
  profiler's overhead."""
  from torch.autograd import DeviceType
  from ble_tpu_torch.train import eval_lib
  steps = 16
  run = eval_lib.build_eval_fn(params, field_fn, *policy(),
                               max_steps=steps, from_states=True,
                               device=DEV)

  def steps_run():
    run(list(range(E)), state0, obs0)
    torch.cuda.synchronize()

  steps_run()
  t = time.perf_counter()
  steps_run()
  wall_ms = 1e3 * (time.perf_counter() - t) / steps
  with _step_ranges():
    device_ms, launches, events = device_time(steps_run, steps)
  ranges = {e.key: e.cpu_time_total / 1e3 / steps for e in events
            if e.key.startswith('step/') and e.device_type == DeviceType.CPU}
  log('profile: host ms per step by part, nested parts inside their '
      'callers (profiled):',
      json.dumps({k: round(v, 2) for k, v in sorted(ranges.items())}))
  log(f'profile: per step {wall_ms:.2f} ms wall (unprofiled), '
      f'{device_ms:.2f} ms of device kernels in {launches:.0f} launches; '
      f'device busy share {device_ms / wall_ms:.3f}')
  sort_by = ('self_device_time_total' if events and hasattr(
      events[0], 'self_device_time_total') else 'self_cuda_time_total')
  log(events.table(sort_by=sort_by, row_limit=25, max_name_column_width=60))
  log(events.table(sort_by='self_cpu_time_total', row_limit=25,
                   max_name_column_width=60))


def main(argv=None) -> int:
  argv = sys.argv[1:] if argv is None else argv
  if argv[:1] == ['--worker']:
    WORKERS[argv[1]](*argv[2:])
    return 0
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--phases', default=','.join(DEFAULT_PHASES),
                      help='comma-separated subset of: ' +
                      ', '.join(DEFAULT_PHASES +
                                ('numerics', 'calibrate', 'profile',
                                 'tile', 'splits')))
  args = parser.parse_args(argv)
  phases = set(args.phases.split(','))

  if not torch.cuda.is_available():
    print('chip_smoke: torch.cuda.is_available() is False; this check needs '
          'an NVIDIA GPU', file=sys.stderr)
    return 1
  import ble_tpu_torch  # noqa: F401  (sets the float32 precision policy)
  from ble_tpu_torch.env import env as env_lib

  t_start = time.perf_counter()

  def mark(phase: str) -> None:
    log(f'phase {phase} done, {time.perf_counter() - t_start:.1f} s in')

  smi = nvidia_smi_line()
  kind = torch.cuda.get_device_name(0)
  log(f'device: {kind}; nvidia-smi: {smi}; torch {torch.__version__}, '
      f'CUDA {torch.version.cuda}')
  if 'build' in phases:
    phase_build()
    mark('build')
  if 'tile' in phases:
    phase_tile()

  params = env_lib.EnvParams(field_cache=True)
  field_fn = state0 = obs0 = gp_state = None
  if phases & {'kernels', 'pair', 'main', 'api', 'params', 'window',
                'train', 'agents', 'distributed', 'timing', 'numerics',
                'profile', 'splits'}:
    field_fn = generative_field_fn()
  if phases & {'kernels', 'main', 'api', 'params', 'window', 'timing',
                'numerics', 'profile', 'splits'}:
    state0, obs0 = reset_main(params, field_fn)
  errs = {}
  if phases & {'kernels', 'timing'}:
    t = time.perf_counter()
    gp_state = warmed_gp_state()
    torch.cuda.synchronize()
    log(f'warmed GP state: E={E}, 140 observations, '
        f'{time.perf_counter() - t:.2f} s')
  if 'kernels' in phases:
    errs['physics'] = check_b1_split(params, state0)
    e1 = check_b2(gp_state, 1)
    e8 = check_b2(gp_state, 8)
    errs['gp_window'] = {'max_abs_err': max(e1['max_abs_err'],
                                            e8['max_abs_err'])}
    errs.update(check_b3_b4_b5(gp_state))
    mark('kernels')
  if 'numerics' in phases:
    phase_numerics(params, state0)
  if 'splits' in phases:
    phase_splits(params, state0)
  if 'calibrate' in phases:
    phase_calibrate()
  if 'reference' in phases:
    phase_reference()
    mark('reference')
  if 'worlds' in phases:
    phase_worlds(field_fn or generative_field_fn())
    mark('worlds')
  # Launches of each kernel on each path that carries it, each path driven
  # with every count set to 0 just before it and read just after: B1, B3
  # and B5 on the gym path (E = 1), B4 and B5 on the pair path, B1 and B2
  # on the main path (E = 4096), on the window path (E = 4096, B2 at K = 8)
  # and on the train, agents and distributed paths (E = 1024; the
  # distributed path's counts come from its worker process).
  launches = {}
  gym_state = None
  if 'gym' in phases:
    gym_launches, gym_state = phase_gym()
    launches.update(gym_launches)
    if 'kernels' in phases:
      errs['physics_gym'] = check_b1(params, gym_state)
    mark('gym')
  if 'pair' in phases:
    launches.update(phase_pair(field_fn))
    mark('pair')
  main_out = None
  if 'main' in phases:
    main_out = phase_main(params, field_fn, state0, obs0)
    launches.update(main_out['launches'])
    mark('main')
  api_out = None
  if 'api' in phases:
    api_out = phase_api(params, state0)
    launches['gp_query_api'] = api_out['column']['launches']
    errs['gp_query_api'] = {
        'max_abs_err': api_out['column']['max_abs_err']}
    mark('api')
  params_out = None
  if 'params' in phases:
    params_out = phase_params(params, state0)
    launches.update(params_out['launches'])
    if 'kernels' in phases:
      errs['physics_params'] = check_b1(params, params_out['state'])
      errs['gp_window_params'] = check_b2(params_out['b2'][0], 1,
                                          params_out['b2'][1])
    mark('params')
  window_out = None
  if 'window' in phases:
    window_out = phase_window(params, state0)
    launches.update(window_out['launches'])
    if 'kernels' in phases:
      errs['physics_window'] = check_b1(params, window_out['state'])
      errs['gp_window_window'] = check_b2(window_out['b2'][0], WINDOW_K,
                                          window_out['b2'][1])
    mark('window')
  train_state = train_b2 = train_summary = None
  if 'train' in phases:
    train_launches, train_state, train_b2, train_summary = phase_train(
        field_fn)
    launches.update(train_launches)
    if 'kernels' in phases:
      errs['physics_train'] = check_b1(params, train_state.env_state)
      errs['gp_window_train'] = check_b2(train_b2[0], 1, train_b2[1])
    mark('train')
  agents_out = None
  if 'agents' in phases:
    agents_out = phase_agents(field_fn)
    launches.update(agents_out['launches'])
    if 'kernels' in phases:
      errs['physics_agents'] = check_b1(params, agents_out['state'])
      errs['gp_window_agents'] = check_b2(agents_out['b2'][0], 1,
                                          agents_out['b2'][1])
    mark('agents')
  dist_out = None
  if 'distributed' in phases:
    dist_out = phase_distributed(params, field_fn, phases, train_summary)
    launches.update(dist_out['launches'])
    errs.update(dist_out['errs'])
    mark('distributed')
  if 'vae' in phases:
    phase_vae()
    mark('vae')
  timing = {}
  if 'timing' in phases:
    timing = phase_timing(params, state0, gp_state, gym_state, train_state,
                          train_b2, window_out, agents_out,
                          api=api_out is not None, params_out=params_out)
    if dist_out is not None:
      timing.update(dist_out['timing'])
    mark('timing')
  if 'profile' in phases:
    phase_profile(params, field_fn, state0, obs0)

  # One row per kernel and path: its launches and its time both come from
  # the path named in `path`, at that path's batch.
  rows = []
  b1 = ('ble_tpu_torch/csrc/physics.cu', 'ble_tpu/ops/pallas_physics.py:184')
  b2 = ('ble_tpu_torch/csrc/gp_window.cu',
        'ble_tpu/ops/pallas_gp_window.py:360')
  b5 = ('ble_tpu_torch/csrc/gp_query.cu', 'ble_tpu/ops/pallas_gp.py:95')
  sources = {
      'physics': b1 + (f'main, E={E}',),
      'physics_gym': b1 + ('gym, E=1',),
      'gp_window': b2 + (f'main, E={E}',),
      'physics_window': b1 + (f'window, E={E}, K={WINDOW_K}',),
      'gp_window_window': b2 + (f'window, E={E}, K={WINDOW_K}',),
      'physics_train': b1 + (f'train, E={TRAIN_E}',),
      'gp_window_train': b2 + (f'train, E={TRAIN_E}',),
      'physics_agents': b1 + (f'agents, E={TRAIN_E}',),
      'gp_window_agents': b2 + (f'agents, E={TRAIN_E}',),
      'physics_distributed': b1 + (f'distributed world 1, E={TRAIN_E}',),
      'gp_window_distributed': b2 + (f'distributed world 1, E={TRAIN_E}',),
      'gp_observe_b3': ('ble_tpu_torch/csrc/gp_observe.cu',
                        'ble_tpu/ops/pallas_gp_observe.py:265', 'gym, E=1'),
      'gp_observe_b4': ('ble_tpu_torch/csrc/gp_observe.cu',
                        'ble_tpu/ops/pallas_gp_observe.py:326',
                        f'pair, E={E}'),
      'gp_query_gym': b5 + ('gym, E=1',),
      'gp_query_pair': b5 + (f'pair, E={E}',),
      'gp_query_api': b5 + (f'api (features.wind_column_features), E={E}',),
      'physics_params': b1 + (f'params (step_batched global_step, '
                              f'field_cache_every={PARAMS_CACHE_EVERY}), '
                              f'E={E}',),
      'gp_window_params': b2 + (f'params (step_batched global_step, '
                                f'field_cache_every={PARAMS_CACHE_EVERY}), '
                                f'E={E}',),
  }
  for name, (source, replaces, path) in sources.items():
    row = {'name': name, 'route': 'cuda', 'source': source,
           'replaces': replaces, 'path': path,
           'launches': launches.get(name),
           'max_abs_err': errs.get(name, {}).get('max_abs_err')}
    t = timing.get(name, {})
    for key in ('ms', 'device_ms', 'plain_ms', 'bound_ms', 'bound_by',
                'library_ms', 'library_device_ms'):
      row[key] = t.get(key)
    rows.append(row)
    if t:
      log(f'timing {name}: {json.dumps(t)}')
      if main_out and name in main_out['launches']:
        share = t['ms'] * main_out['launches'][name] / MAIN_STEPS
        log(f'  {name}: {share:.3f} ms of each {main_out["per_step_ms"]:.3f}'
            f' ms main-path step')
      if window_out and name in window_out['launches']:
        share = (t['ms'] * window_out['launches'][name] /
                 (WINDOW_K * WINDOW_COUNT))
        log(f'  {name}: {share:.3f} ms of each '
            f'{window_out["summary"]["ms_per_step"]:.3f} ms window-path step')
  print(json.dumps({'kernels': rows}))
  print(nvidia_smi_line())
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
