"""The frozen work counts at known shapes, against counts by hand."""

from portbench import workcount


def test_b1_counts_e_times_18_substeps():
  ops = workcount.b1_ops(10)
  assert ops['fp32'] == 10 * 18 * 521
  assert ops['special'] == 10 * 18 * 118
  assert ops['alu'] == 10 * 18 * 355
  assert ops['bytes'] == 4 * 10 * (45 + 19)


def test_b2_query_counts_the_symmetric_form():
  # One level: x/y/t distances 1280, k* 8 x 128, means 4 x 128, the
  # symmetric form 128 x 129, its dot 2 x 128, the clip 4.
  assert workcount.query_flops(1) == 1280 + 1024 + 512 + 16512 + 256 + 4
  observe = 131072 + 4096 + 3840 + 278528 + 65536
  assert workcount.OBSERVE_FLOPS == observe
  assert workcount.b2_flops(3, 2) == 6 * (observe +
                                          workcount.query_flops(181))


def test_qrdqn_network_flops():
  widths = workcount.qrdqn_widths(1099, 8, 600, 3, 51)
  assert widths == [1099] + [600] * 7 + [153]
  forward = 2 * (1099 * 600 + 6 * 600 * 600 + 600 * 153)
  assert workcount.mlp_forward_flops(widths) == forward == 5822400
  assert workcount.qrdqn_grad_step_flops(widths, 32) == 4 * 32 * forward


def test_bounds_take_the_slowest_unit():
  pk = workcount.peaks()
  e = 4096
  assert workcount.b1_bound_s(e) == max(
      workcount.b1_ops(e)['special'] / pk['special_function_results_per_s'],
      workcount.b1_ops(e)['fp32'] / pk['fp32_flops_per_s'],
      workcount.b1_ops(e)['alu'] / pk['alu_results_per_s'],
      workcount.b1_ops(e)['bytes'] / pk['hbm_bytes_per_s'])
  assert workcount.b2_bound_s(e) == workcount.b2_flops(e) / pk[
      'fp32_flops_per_s']
