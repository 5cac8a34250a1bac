"""Evaluation CLI (the port of ble_tpu/train/eval.py; reference eval/eval.py).

Example, from the root of a checkout (writes
results/eval/station_seeker_tiny_eval.json there):
  python -m ble_tpu_torch.train.eval --agent station_seeker \\
      --suite tiny_eval --wind_field generative

The generative field decodes one grid per seed with the VAE decoder that
models/loader.py resolves (the deterministic fallback when no trained blob
is found). `--agent quantile|finetune_perciatelli|dqn|mlp|r2d2
--checkpoint_dir <base_dir>` evaluates the greedy policy of the latest
checkpoint that train.py wrote there (r2d2's policy carries its LSTM state
from step to step); `--agent perciatelli44`, and finetune_perciatelli
without a checkpoint, the converted Perciatelli44 weights that
models/loader.py resolves.

`--num_shards N --shard_idx i` evaluates the seeds suite.seeds[i::N] and
adds _<i> to the output's name (reference eval/eval.py:125-128); python -m
ble_tpu_torch.train.combine_eval_shards merges the shards' files.
`--flight_path` also records each seed's track (x, y, pressure,
superpressure, elapsed seconds, state of charge) up to its final step.
"""

import argparse
import os

from ble_tpu_torch import resolve_device
from ble_tpu_torch.agents import base
from ble_tpu_torch.agents import networks
from ble_tpu_torch.agents import perciatelli44
from ble_tpu_torch.agents import qrdqn
from ble_tpu_torch.agents import random_walk
from ble_tpu_torch.agents import station_seeker
from ble_tpu_torch.env import env as env_lib
from ble_tpu_torch.models import loader
from ble_tpu_torch.train import eval_lib
from ble_tpu_torch.train import learner as learner_lib
from ble_tpu_torch.train import suites
from ble_tpu_torch.train import train_lib

AGENTS = ('station_seeker', 'random', 'random_walk', 'perciatelli44',
          'quantile', 'finetune_perciatelli', 'dqn', 'mlp', 'r2d2')


def make_policy_fns(agent_name: str, checkpoint_dir=None, device=None
                    ) -> base.Policy:
  """(policy_init, policy_step, policy_draw) for the batched evaluator
  (agents/base.py), as ble_tpu/train/eval.py:make_policy_fns gives them."""
  if agent_name == 'station_seeker':
    return base.Policy(
        lambda keys, dev: (),
        lambda state, obs, draws: (state, station_seeker.pick_action(obs)))
  if agent_name == 'random':
    return random_walk.random_policy(env_lib.NUM_ACTIONS)
  if agent_name == 'random_walk':
    return base.Policy(random_walk.init, random_walk.step, random_walk.draw)
  if agent_name == 'perciatelli44':
    policy = perciatelli44.make_policy(
        loader.load_perciatelli44(device=device))
    return base.Policy(lambda keys, dev: (),
                       lambda state, obs, draws: (state, policy(obs)))
  if agent_name in learner_lib.TRAINABLE_AGENTS:
    config = learner_lib.TrainConfig(agent=agent_name)
    if agent_name == 'finetune_perciatelli' and checkpoint_dir is None:
      return learner_lib.make_eval_policy(
          config, loader.load_perciatelli44(device=device))
    if checkpoint_dir is None:
      raise ValueError(f'{agent_name} needs --checkpoint_dir')
    # The network's widths come from the checkpoint's tensors, so the
    # training run's replay and env sizes do not matter here.
    params, _ = train_lib.restore_latest_learner_params(checkpoint_dir)
    if agent_name in ('dqn', 'mlp'):
      network = networks.mlp_network_from_params(params, device)
    elif agent_name == 'r2d2':
      network = networks.lstm_network_from_params(
          params, env_lib.NUM_ACTIONS, device)
    else:
      network = qrdqn.network_from_params(params, env_lib.NUM_ACTIONS,
                                          device)
    return learner_lib.make_eval_policy(config, network)
  raise ValueError(f'Unknown agent: {agent_name}')


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--agent', type=str, default='station_seeker',
                      choices=AGENTS)
  parser.add_argument('--suite', type=str, default='micro_eval',
                      choices=suites.available_suites())
  parser.add_argument('--wind_field', type=str, default='generative',
                      choices=['generative', 'static'])
  parser.add_argument('--output_dir', type=str,
                      default=os.path.join('results', 'eval'),
                      help='Where the results JSON goes (relative paths '
                      'from the working directory).')
  parser.add_argument('--checkpoint_dir', type=str, default=None,
                      help='Base directory of a training run (the '
                      'trainable agents).')
  parser.add_argument('--batch_size', type=int, default=4096,
                      help='Seeds evaluated per device batch.')
  parser.add_argument('--num_shards', type=int, default=1)
  parser.add_argument('--shard_idx', type=int, default=0)
  parser.add_argument('--flight_path', action='store_true',
                      help='Record each seed\'s flight path in the JSON.')
  parser.add_argument('--device', type=str, default='cuda')
  parser.add_argument('--f32_grid', action='store_true',
                      help='Store forecast grids in float32 instead of bf16.')
  parser.add_argument('--no_field_cache', action='store_true',
                      help='Disable the windowed field-slab cache.')
  args = parser.parse_args(argv)

  if not 0 <= args.shard_idx < args.num_shards:
    raise ValueError(f'--shard_idx {args.shard_idx} outside '
                     f'[0, {args.num_shards})')
  device = resolve_device(args.device)
  suite = suites.get_eval_suite(args.suite)
  seeds = suite.seeds[args.shard_idx::args.num_shards]
  env_params = env_lib.EnvParams(wind_field_f32=args.f32_grid,
                                 field_cache=not args.no_field_cache)
  if args.wind_field == 'generative':
    field_fn = env_lib.make_field_fn(
        'generative', loader.load_offlineskies22(device=device))
  else:
    field_fn = env_lib.make_field_fn('static')
  policy_init, policy_step, policy_draw = make_policy_fns(
      args.agent, args.checkpoint_dir, device)
  eval_fn = eval_lib.build_eval_fn(
      env_params, field_fn, policy_init, policy_step,
      max_steps=suite.max_episode_length,
      record_flight_path=args.flight_path, device=device,
      policy_draw=policy_draw)
  results = eval_lib.evaluate(eval_fn, seeds,
                              batch_size=min(args.batch_size, len(seeds)))
  os.makedirs(args.output_dir, exist_ok=True)
  shard = f'_{args.shard_idx}' if args.num_shards > 1 else ''
  out_path = os.path.join(args.output_dir,
                          f'{args.agent}_{args.suite}{shard}.json')
  eval_lib.write_results_json(results, out_path, args.agent, args.suite)
  print(eval_lib.summarize(results))
  print(f'Wrote {out_path}')


if __name__ == '__main__':
  main()
