"""Sharded evaluation in the port on the CPU: the eval CLI's --num_shards,
--shard_idx and --flight_path, combine_eval_shards, and
eval_lib.evaluate_distributed over 2 gloo ranks, each against the
unsharded run; combine_shard_results against ble_tpu's."""

import json

import pytest

from ble_tpu.train import eval_lib as jax_eval_lib
from ble_tpu_torch.agents import station_seeker
from ble_tpu_torch.env import env as env_lib
from ble_tpu_torch.train import combine_eval_shards
from ble_tpu_torch.train import eval as eval_cli
from ble_tpu_torch.train import eval_lib
from ble_tpu_torch.train import suites

import torch_dist_workers as workers

SEEDS = [0, 1, 2, 3, 4]
STEPS = 8


def _eval(out_dir, *extra, agent='station_seeker'):
  eval_cli.main(['--agent', agent, '--suite', 'micro_eval',
                 '--wind_field', 'static', '--device', 'cpu',
                 '--output_dir', str(out_dir), *extra])


@pytest.fixture
def cut_suite(monkeypatch):
  """micro_eval cut to SEEDS for STEPS steps."""
  monkeypatch.setattr(eval_cli.suites, 'get_eval_suite',
                      lambda name: suites.EvaluationSuite(SEEDS, STEPS))


def _results(path):
  with open(path) as f:
    return json.load(f)['results']


def test_two_shards_combined_equal_the_unsharded_run(tmp_path, cut_suite):
  """--num_shards 2 --shard_idx 0 and 1 evaluate seeds [0, 2, 4] and
  [1, 3] into station_seeker_micro_eval_0.json and _1.json;
  combine_eval_shards merges them into the unsharded run's results, seed
  for seed. The port's combine_shard_results and ble_tpu's read the same
  files into equal lists."""
  _eval(tmp_path / 'whole')
  whole = _results(tmp_path / 'whole' / 'station_seeker_micro_eval.json')
  shards = []
  for idx in (0, 1):
    _eval(tmp_path / 'shards', '--num_shards', '2', '--shard_idx', str(idx))
    shards.append(str(tmp_path / 'shards' /
                      f'station_seeker_micro_eval_{idx}.json'))
  assert [r['seed'] for r in _results(shards[0])] == [0, 2, 4]
  assert [r['seed'] for r in _results(shards[1])] == [1, 3]
  out = str(tmp_path / 'combined.json')
  assert combine_eval_shards.main([out] + shards) == 0
  assert _results(out) == whole
  assert [r['seed'] for r in whole] == SEEDS
  assert eval_lib.combine_shard_results(shards[::-1]) == (
      jax_eval_lib.combine_shard_results(shards[::-1])) == whole
  assert combine_eval_shards.main([out]) == 1
  with pytest.raises(ValueError, match='shard_idx'):
    _eval(tmp_path / 'bad', '--num_shards', '2', '--shard_idx', '2')


def test_flight_path_writes_the_final_timestep_rows(tmp_path, cut_suite):
  """--flight_path: each result carries final_timestep rows of the track
  with build_eval_fn's six fields; without it, none."""
  _eval(tmp_path, '--flight_path')
  results = _results(tmp_path / 'station_seeker_micro_eval.json')
  for r in results:
    path = r['flight_path']
    assert len(path) == r['final_timestep'] > 0
    assert set(path[0]) == {'x', 'y', 'pressure', 'superpressure',
                            'elapsed_seconds', 'power'}
    assert path[-1]['elapsed_seconds'] > path[0]['elapsed_seconds']
  _eval(tmp_path / 'plain')
  plain = _results(tmp_path / 'plain' / 'station_seeker_micro_eval.json')
  assert all(r['flight_path'] is None for r in plain)
  assert [dict(r, flight_path=None) for r in results] == plain


def test_evaluate_distributed_equals_evaluate(tmp_path, monkeypatch):
  """evaluate_distributed over 2 gloo ranks (blocks of 3 and 2 seeds):
  every rank returns the whole list in seed order, equal to evaluate's in
  one process."""
  monkeypatch.setenv('OMP_NUM_THREADS', '1')
  ranks = workers.spawn(workers.eval_worker, tmp_path, SEEDS, STEPS)
  eval_fn = eval_lib.build_eval_fn(
      env_lib.EnvParams(), env_lib.make_field_fn('static'),
      lambda n, gen: (),
      lambda state, obs, gen: (state, station_seeker.pick_action(obs)),
      max_steps=STEPS, device='cpu')
  want = eval_lib.evaluate(eval_fn, SEEDS)
  assert ranks[0] == ranks[1] == want
  assert eval_lib.evaluate_distributed(eval_fn, SEEDS) == want


@pytest.mark.parametrize('agent', ['random', 'random_walk'])
def test_a_seeds_random_draws_do_not_depend_on_its_batch(tmp_path,
                                                         monkeypatch, agent):
  """The agents that draw: seed 1 evaluated alone, in the batch [0, 1] and
  in shard 1 of `--num_shards 2` over [0, 1, 2, 3] (the batch [1, 3])
  gives the same result in bits, as ble_tpu's per-seed keys give
  (ble_tpu/train/eval_lib.py:136-139,182)."""
  got = []
  for seeds, extra in (([1], ()), ([0, 1], ()),
                       ([0, 1, 2, 3], ('--num_shards', '2', '--shard_idx',
                                       '1'))):
    monkeypatch.setattr(eval_cli.suites, 'get_eval_suite',
                        lambda name, seeds=seeds: suites.EvaluationSuite(
                            seeds, STEPS))
    out_dir = tmp_path / str(len(got))
    _eval(out_dir, *extra, agent=agent)
    shard = '_1' if extra else ''
    results = _results(out_dir / f'{agent}_micro_eval{shard}.json')
    got.append(next(r for r in results if r['seed'] == 1))
  assert got[0] == got[1] == got[2]
