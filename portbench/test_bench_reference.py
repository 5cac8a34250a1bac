"""The plain env step in reference/sim/ is a frozen copy of the port's CPU
path at one commit, without its kernel routes (reference/sim/sources.json:
each file's source, its git blob at that commit, the copy's sha256 and
the lines the copy adds). Its imports are rewritten to point here."""

import hashlib
import json
import os
import re
import subprocess

import pytest

from portbench import harness

SIM = os.path.join(harness.HERE, 'reference', 'sim')
with open(os.path.join(SIM, 'sources.json')) as _f:
  SOURCES = json.load(_f)
IMPORT = re.compile(r'from ble_tpu_torch\.(env|utils|ops|generative) import')


def test_every_copy_is_listed():
  copies = {f for f in os.listdir(SIM) if f.endswith('.py')}
  assert copies == set(SOURCES['files'])


@pytest.mark.parametrize('name', sorted(SOURCES['files']))
def test_copy_is_frozen(name):
  with open(os.path.join(SIM, name), 'rb') as f:
    digest = hashlib.sha256(f.read()).hexdigest()
  assert digest == SOURCES['files'][name]['sha256']


def _git(*args):
  return subprocess.run(['git', '-C', harness.ROOT, *args],
                        capture_output=True, text=True)


@pytest.mark.parametrize('name', sorted(SOURCES['files']))
def test_copy_is_its_source_at_the_commit(name):
  entry = SOURCES['files'][name]
  if _git('cat-file', '-e', SOURCES['commit'] + '^{commit}').returncode:
    pytest.skip('needs the git history that holds the copied commit')
  blob = _git('rev-parse', f'{SOURCES["commit"]}:{entry["source"]}')
  assert blob.stdout.strip() == entry['blob']
  source = IMPORT.sub('from portbench.reference.sim import',
                      _git('cat-file', '-p', entry['blob']).stdout)
  lines = set(source.splitlines())
  with open(os.path.join(SIM, name)) as f:
    added = [line for line in f.read().splitlines() if line not in lines]
  assert added == entry['added']
