"""StationSeeker (the port's agents/station_seeker.py), which evaluates
and never learns: its eval policy and its number against
reference/station_seeker.py (policies/__init__.py lists what each policy
module gives).

policy: how far its chosen actions score below the best level under the
reference's scores of the same observations (exact), with no control:
the comparison is of integers.
"""

from portbench.reference import station_seeker as ref_seeker


def _no_learner(*_):
  raise ValueError('StationSeeker does not learn: it takes eval traffic '
                   'only')


train_config = load = _no_learner


def weights(seed: int, cfg, obs_dim: int, device):
  return None


def eval_policy(cfg, num_envs: int, weights, device):
  from ble_tpu_torch.agents import station_seeker
  return (lambda keys, device: ()), (
      lambda state, obs, draws: (state, station_seeker.pick_action(obs)))


def install(capture, cfg, train_config, chunk: int):
  """Nothing of its own: the runner keeps its observations and actions."""


def spans(spans):
  """Nothing: it takes no train traffic, and the eval runner spans the
  policy's step itself."""


def numbers(capture, weights, cfg, control=False):
  if control:
    return {}
  return {'policy': max(float(ref_seeker.action_gap(r['obs'],
                                                    r['actions']).max())
                        for r in capture.policy.values())}


def work(cfg, obs_dim: int, batch: int):
  """No network: its scores are not counted."""
  return {'train_step': 0.0, 'actor_row': 0.0}
