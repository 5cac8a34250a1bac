"""The policy-specific parts of the runners and the check, one module a
policy, chosen by the configuration's `policy` key (configs/<c>.json):
`load(cfg['policy'])` imports policies/<policy>.py. A module gives

  train_config(cfg, num_envs)    the learner's TrainConfig, train traffic
  weights(seed, cfg, obs_dim, device)
                                 the network's weights from the seed, on
                                 the device (None for a policy without)
  load(train_state, weights)     those weights into a fresh train state
  eval_policy(cfg, num_envs, weights, device)
                                 (init, step) for the batched evaluator
  install(capture, cfg, train_config, chunk)
                                 rebinds the policy's own entry points for
                                 check.Capture (train_config None: eval)
  spans(spans)                   installs the `policy` span (trace.Spans)
                                 on the actor, for train traffic
  numbers(capture, weights, cfg, control=False)
                                 the policy's and the learner's numbers
                                 against reference/, or the control's
  work(cfg, obs_dim, batch)      {'train_step': FLOPs of one train step of
                                 `batch` rows, 'actor_row': FLOPs of one
                                 actor row}, read by the mfu metrics
"""

import importlib

FUNCTIONS = ('train_config', 'weights', 'load', 'eval_policy', 'install',
             'spans', 'numbers', 'work')


def load(policy: str):
  """policies/<policy>.py."""
  return importlib.import_module(f'{__name__}.{policy}')
