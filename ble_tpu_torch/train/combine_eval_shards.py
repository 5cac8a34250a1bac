"""Merges sharded eval JSON outputs (the port of
ble_tpu/train/combine_eval_shards.py; reference
eval/combine_eval_shards.py).

  python -m ble_tpu_torch.train.combine_eval_shards out.json \\
      shard0.json shard1.json
"""

import json
import sys

from ble_tpu_torch.train import eval_lib


def main(argv=None) -> int:
  argv = sys.argv[1:] if argv is None else argv
  if len(argv) < 2:
    print(__doc__)
    return 1
  out_path, shard_paths = argv[0], argv[1:]
  combined = eval_lib.combine_shard_results(shard_paths)
  with open(out_path, 'w') as f:
    json.dump({'results': combined}, f)
  print(f'Wrote {len(combined)} results to {out_path}')
  return 0


if __name__ == '__main__':
  sys.exit(main())
