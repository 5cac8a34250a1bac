"""Offline converter: perciatelli44.pb (a frozen TF1 graph) -> a flax-format
msgpack (the port of ble_tpu/models/convert_perciatelli44.py).

The reference runs the frozen TF1 session at inference time
(agents/perciatelli44.py:26-40). Here conversion is a one-time step on the
CPU; both packages' loaders read its output (models/loader.py). TensorFlow
is imported only when `convert` runs, and the msgpack is written with the
`msgpack` module in flax.serialization's format: {'params': {'Dense_i':
{'kernel', 'bias'}}}, each ndarray leaf as extension 1 holding (shape,
dtype name, bytes), which loader.read_flax_msgpack reads back.

Usage:
  python -m ble_tpu_torch.models.convert_perciatelli44 perciatelli44.pb \\
      out.msgpack
"""

import sys

import numpy as np

# flax.serialization's msgpack extension code for an ndarray.
_EXT_NDARRAY = 1
NUM_LAYERS = 8


def write_flax_msgpack(tree) -> bytes:
  """A nested dict of numpy arrays in flax.serialization's msgpack
  format."""
  import msgpack

  def default(obj):
    if isinstance(obj, np.ndarray):
      obj = np.ascontiguousarray(obj)
      return msgpack.ExtType(_EXT_NDARRAY, msgpack.packb(
          (obj.shape, obj.dtype.name, obj.tobytes())))
    raise TypeError(f'cannot serialize {type(obj)}')

  return msgpack.packb(tree, default=default)


def convert(pb_path: str, out_path: str) -> None:
  import tensorflow as tf

  with open(pb_path, 'rb') as f:
    serialized = f.read()
  graph_def = tf.compat.v1.GraphDef()
  graph_def.ParseFromString(serialized)
  # An explicit Graph: under TF2's eager default, import_graph_def after
  # Session() lands in another default graph and every lookup fails.
  graph = tf.compat.v1.Graph()
  with graph.as_default():
    tf.compat.v1.import_graph_def(graph_def, name='')

  # The frozen graph stores the online tower as
  # Online/fully_connected[_k]/{weights,biases} (reference
  # quantile_agent.py:216-252).
  params = {}
  with tf.compat.v1.Session(graph=graph) as sess:
    for i in range(NUM_LAYERS):
      scope = 'Online/fully_connected' + ('' if i == 0 else f'_{i}')
      kernel = sess.run(graph.get_tensor_by_name(f'{scope}/weights:0'))
      bias = sess.run(graph.get_tensor_by_name(f'{scope}/biases:0'))
      params[f'Dense_{i}'] = {'kernel': np.asarray(kernel, np.float32),
                              'bias': np.asarray(bias, np.float32)}
  with open(out_path, 'wb') as f:
    f.write(write_flax_msgpack({'params': params}))
  print(f'Wrote {out_path}')


if __name__ == '__main__':
  if len(sys.argv) != 3:
    print(__doc__)
    sys.exit(1)
  convert(sys.argv[1], sys.argv[2])
