"""The work counts against hand-counted tiny cases."""

from bench_port import counts


def test_k1_counts_bytes_and_operations_by_hand():
    # 2 Gaussians, no features, 3 listed instances, 5 blended pairs, one 16x16 tile:
    # per Gaussian 4 * (2 + 3 + 1 + 3) bytes and a visibility byte, 4 a listed
    # instance, 2 tile bounds, bg, and the 3-channel image with T written
    w = counts.k1(n=2, features=0, instances=3, blended=5, width=16, height=16)
    assert w.nbytes == 2 * 36 + 2 + 12 + 8 + 12 + 4 * 4 * 256
    assert w.ops == (11 + 6 + 2 * 3) * 5


def test_k2_counts_full_and_feature_mode_by_hand():
    full = counts.k2(n=2, features=0, feature_only=False, instances=3, blended=5,
                     width=16, height=16)
    # 9 gradient rows an instance; per blended pair 11 + 30 + 3 * 3 + 9
    assert full.nbytes == 2 * 36 + 2 + 24 + 8 + 4 * 6 * 256 + 4 * 9 * 3
    assert full.ops == (11 + 30 + 9 + 9) * 5
    feat = counts.k2(n=2, features=3, feature_only=True, instances=3, blended=5,
                     width=16, height=16)
    assert feat.nbytes == 2 * 48 + 2 + 24 + 8 + 4 * 9 * 256 + 4 * 3 * 3
    assert feat.ops == (11 + 6 + 6) * 5


def test_k3_counts_rows_by_instances():
    w = counts.k3(n=4, features=0, feature_only=False, instances=10)
    assert w.nbytes == 4 * 9 * 10 + 4 * 5 + 4 * 9 * 4
    assert w.ops == 90


def test_bound_is_the_larger_of_bytes_and_operations():
    assert counts.Work(3.35e12, 0).bound_s() == 1.0
    assert counts.Work(0, 67e12).bound_s() == 1.0
    assert counts.Work(3.35e12, 2 * 67e12).bound_s() == 2.0


def test_train_step_adds_the_kernels_and_the_per_element_work():
    k = dict(instances=3, blended=5, width=16, height=16)
    step = counts.train_step("A", capacity=2, trained_floats=118, features=3, **k)
    kernels = (counts.k1(2, 0, 3, 5, 16, 16) + counts.k2(2, 0, False, 3, 5, 16, 16)
               + counts.k3(2, 0, False, 3))
    extra = (counts.PREPROCESS_OPS + counts.PREPROCESS_BWD_OPS) * 2 + \
        counts.ADAM_OPS * 118 + 3 * 256 * (counts.SSIM_OPS + 2 * counts.L1_OPS)
    assert step.nbytes == kernels.nbytes
    assert step.ops == kernels.ops + extra
