"""Training CLI (the port of ble_tpu/train/train.py; reference
train.py:73-95).

Examples, from the root of a checkout:
  python -m ble_tpu_torch.train.train --agent quantile \\
      --base_dir runs/quantile --num_iterations 200
  python -m ble_tpu_torch.train.train --device cpu --wind_field static \\
      --num_iterations 2 --max_episode_length 16 --set num_envs=4 \\
      --set replay.ring_len=64 --set replay.batch_size=8 \\
      --set qrdqn.min_replay_history=8

`--agent` takes every trainable agent of the JAX package: quantile,
finetune_perciatelli, dqn, mlp and r2d2; `--set` reaches each one's config
(qrdqn.*, dqn.*, r2d2.*) and replay.*. `--render_final` saves env 0's
flight path over the last iteration as <base_dir>/final_flight_path.png. The generative field decodes one
grid per world seed with the VAE decoder that models/loader.py resolves.
"""

import argparse
import json
import logging
import os
import time

from ble_tpu_torch import config as config_lib
from ble_tpu_torch import resolve_device
from ble_tpu_torch.env import env as env_lib
from ble_tpu_torch.models import loader
from ble_tpu_torch.train import eval_lib
from ble_tpu_torch.train import learner as learner_lib
from ble_tpu_torch.train import suites
from ble_tpu_torch.train import train_lib


def make_periodic_eval(base_dir, env_params, field_fn, config,
                       eval_suite: str, t_start: float, device):
  """Greedy-policy eval on a suite (ble_tpu/train/train.py:27-64); appends
  one JSON line per call to base_dir/learning_curve.jsonl. The eval
  function is built once a run and given the learner's current network at
  each call. train_steps is the learner's count for every agent (the JAX
  package writes 0 for mlp, whose online state has none)."""
  core = learner_lib.make_agent_core(config)
  policy = learner_lib.make_parametric_eval_policy(config)
  suite = suites.get_eval_suite(eval_suite)
  eval_fn = eval_lib.build_parametric_eval_fn(
      env_params, field_fn, policy.init, policy.step,
      max_steps=suite.max_episode_length, device=device)
  curve_path = os.path.join(base_dir, 'learning_curve.jsonl')

  def eval_cb(ts, iteration):
    network = core.params_of(ts.learner)
    summary = eval_lib.summarize(eval_lib.evaluate(
        lambda seeds: eval_fn(network, seeds), suite.seeds))
    record = {
        'iteration': iteration,
        'env_steps': ts.env_steps * config.num_envs,
        'train_steps': ts.learner.train_steps,
        'wall_s': time.time() - t_start,
        **summary,
    }
    with open(curve_path, 'a') as f:
      f.write(json.dumps(record) + '\n')
    logging.info('eval @ iter %d: TWR %.3f reward %.1f (%d seeds)',
                 iteration, summary['mean_twr'],
                 summary['mean_cumulative_reward'], summary['num_seeds'])

  return eval_cb


def main(argv=None):
  logging.basicConfig(level=logging.INFO,
                      format='%(asctime)s %(levelname)s %(message)s')
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--base_dir', type=str, default=None,
                      help='Directory for checkpoints/metrics.')
  parser.add_argument('--agent', type=str, default='quantile',
                      choices=learner_lib.TRAINABLE_AGENTS)
  parser.add_argument('--num_iterations', type=int, default=200)
  parser.add_argument('--episodes_per_iteration', type=int, default=1)
  parser.add_argument('--max_episode_length', type=int, default=960)
  parser.add_argument('--wind_field', type=str, default='generative',
                      choices=['generative', 'static'])
  parser.add_argument('--collectors', type=str, default='console',
                      help='Comma-separated: console,pickle,tensorboard')
  parser.add_argument('--seed', type=int, default=0)
  parser.add_argument('--eval_every', type=int, default=0,
                      help='Eval cadence in iterations (0 = never).')
  parser.add_argument('--eval_suite', type=str, default='small_eval',
                      choices=suites.available_suites())
  parser.add_argument('--render_final', action='store_true',
                      help='Save the final iteration flight-path render '
                           '(reference train.py:95-109).')
  parser.add_argument('--max_hours', type=float, default=None,
                      help='Wall-clock budget; checkpoints and exits.')
  parser.add_argument('--set', action='append', default=[],
                      help='TrainConfig override, e.g. num_envs=512')
  parser.add_argument('--no_field_cache', action='store_true',
                      help='Disable the windowed field-slab cache '
                      '(EnvParams.field_cache; on by default).')
  parser.add_argument('--device', type=str, default='cuda')
  args = parser.parse_args(argv)

  device = resolve_device(args.device)
  config = learner_lib.TrainConfig(agent=args.agent)
  config = config_lib.apply_overrides(config, args.set)

  env_params = env_lib.EnvParams(field_cache=not args.no_field_cache)
  if args.wind_field == 'generative':
    field_fn = env_lib.make_field_fn(
        'generative', loader.load_offlineskies22(device=device))
  else:
    field_fn = env_lib.make_field_fn('static')

  eval_cb = None
  if args.eval_every > 0 and args.base_dir:
    eval_cb = make_periodic_eval(args.base_dir, env_params, field_fn, config,
                                 args.eval_suite, time.time(), device)

  return train_lib.run_training_loop(
      base_dir=args.base_dir,
      env_params=env_params,
      field_fn=field_fn,
      config=config,
      num_iterations=args.num_iterations,
      episodes_per_iteration=args.episodes_per_iteration,
      episode_length=args.max_episode_length,
      collectors=[c for c in args.collectors.split(',') if c],
      seed=args.seed,
      eval_fn=eval_cb,
      eval_every=args.eval_every,
      render_final=args.render_final,
      max_seconds=None if args.max_hours is None else args.max_hours * 3600,
      device=device)


if __name__ == '__main__':
  main()
