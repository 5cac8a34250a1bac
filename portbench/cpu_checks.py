"""The tiny CPU runs of the cells in test_bench_cells.py (run_cpu, at its
seed), of one or more checkouts, with every number that decides
`correct` printed exactly (float.hex), and whether two checkouts agree
bit for bit:

  python3 portbench/cpu_checks.py <checkout> [<checkout> ...]

Each checkout runs in a process of its own, from its own portbench/ and
ble_tpu_torch/, on this machine's CPU.
"""

import json
import os
import subprocess
import sys

_RUN = '''
import json, sys
sys.path.insert(0, {root!r})
from portbench import test_bench_cells as t
out = {{}}
for name in t.CELLS:
  result = t.run_cpu(name)
  out[name] = {{'correct': result['correct'],
               'checks': {{k: float(v['value']).hex()
                          for k, v in result['checks'].items()}}}}
print(json.dumps(out))
'''


def checks_of(root: str) -> dict:
  root = os.path.abspath(root)
  env = dict(os.environ, PYTHONPATH='')
  out = subprocess.run([sys.executable, '-c', _RUN.format(root=root)],
                       cwd=root, env=env, capture_output=True, text=True,
                       check=True)
  return json.loads(out.stdout.strip().splitlines()[-1])


def main(roots) -> int:
  results = [checks_of(root) for root in roots]
  for root, result in zip(roots, results):
    print(json.dumps({'checkout': root, 'cells': result}))
  same = all(r == results[0] for r in results[1:])
  print(json.dumps({'bit_for_bit': same}))
  return 0 if same else 1


if __name__ == '__main__':
  sys.exit(main(sys.argv[1:]))
