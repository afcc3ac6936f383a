"""End-to-end CLI smoke tests: the §3.1/§3.2 call stacks on tiny budgets —
train writes best-gated checkpoints + meta, test restores by suffix and
reports NLL (SURVEY.md §3.3)."""

import glob
import os
import sys

import numpy as np
import pytest


def _run_cli(argv):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import run as run_mod
    run_mod.main(argv)


def test_regression_train_then_test(tmp_path):
    ckpt_root = str(tmp_path / "ckpt")
    _run_cli([
        "reg", "tr", "-m", "tp", "-dn", "syn-normal", "-cr", ckpt_root,
        "-cn", "smoke", "-t", "20", "-vi", "10", "-pi", "10", "-nh", "2", "-eps", "1e-2", "-q",
    ])
    ckpt_dir = os.path.join(ckpt_root, "smoke")
    assert glob.glob(os.path.join(ckpt_dir, "*.npz")), "no checkpoint saved"
    assert os.path.isfile(os.path.join(ckpt_dir, "meta.npy"))
    log = open(os.path.join(ckpt_dir, "train.log")).read()
    assert "NLL:" in log and "Traceback" not in log

    _run_cli(["reg", "ts", "-cd", ckpt_dir, "-q"])
    test_log = open(os.path.join(ckpt_dir, "test", "test.log")).read()
    assert "NLL:" in test_log and "Traceback" not in test_log

    # predict (serving path): fitted NLL on the test split must equal the
    # test subcommand's per-request NLL, and the fitted-state cache must be
    # written then reused on a second request.
    fitted_path = os.path.join(ckpt_dir, "fitted.npz")
    _run_cli(["reg", "pr", "-cd", ckpt_dir, "-fs", fitted_path, "-q"])
    pred_log = open(os.path.join(ckpt_dir, "predict", "predict.log")).read()
    assert "Traceback" not in pred_log and os.path.isfile(fitted_path)
    preds = np.load(os.path.join(ckpt_dir, "predictions.npz"))
    assert preds["mean"].shape == preds["var"].shape
    assert np.all(np.isfinite(preds["mean"])) and np.all(preds["var"] > 0)
    nll_test = float(test_log.split("NLL:")[-1].split()[0])
    nll_pred = float(pred_log.split("NLL:")[-1].split()[0])
    # rtol 5e-3: un-jitted, FittedSPR.test_nll equals SPR.test_nll exactly
    # (test_predictor.py pins 3e-5); across two *different jitted programs*
    # the syn-normal Gram's near-singular predictive variances (~1e-5)
    # amplify XLA fusion reassociation to ~1e-3 relative on the NLL.
    np.testing.assert_allclose(nll_pred, nll_test, rtol=5e-3)

    _run_cli(["reg", "pr", "-cd", ckpt_dir, "-fs", fitted_path, "-q"])
    pred_log2 = open(os.path.join(ckpt_dir, "predict", "predict.log")).read()
    assert "loaded fitted state" in pred_log2 and "Traceback" not in pred_log2

    # predict --add-x/--add-y: grow the conditioning set in O(N^2 m) via
    # chol_append. The cached fitted state predates extendable=True, so the
    # refit branch runs too.
    from snngp.data.regression import get_dataset
    x_raw, y_raw = get_dataset(name="syn-normal", root="./data")
    np.save(str(tmp_path / "add_x.npy"), np.asarray(x_raw[-12:]))
    np.save(str(tmp_path / "add_y.npy"), np.asarray(y_raw[-12:]))
    _run_cli(["reg", "pr", "-cd", ckpt_dir, "-fs", fitted_path,
              "-ax", str(tmp_path / "add_x.npy"),
              "-ay", str(tmp_path / "add_y.npy"), "-q"])
    pred_log3 = open(os.path.join(ckpt_dir, "predict", "predict.log")).read()
    assert "extended conditioning set by 12" in pred_log3
    assert "Traceback" not in pred_log3
    preds3 = np.load(os.path.join(ckpt_dir, "predictions.npz"))
    assert np.all(np.isfinite(preds3["mean"])) and np.all(preds3["var"] > 0)


def test_regression_train_gp_smoke(tmp_path):
    ckpt_root = str(tmp_path / "ckpt")
    _run_cli([
        "reg", "tr", "-m", "gp", "-dn", "syn-normal", "-cr", ckpt_root,
        "-cn", "smoke-gp", "-t", "10", "-vi", "5", "-pi", "5", "-nh", "2", "-eps", "1e-2",
        "-n", "resnet", "-q",
    ])
    log = open(os.path.join(ckpt_root, "smoke-gp", "train.log")).read()
    assert "NLL:" in log and "Traceback" not in log


@pytest.mark.slow
def test_classification_train_then_test(tmp_path):
    ckpt_root = str(tmp_path / "ckpt")
    _run_cli([
        "cls", "tr", "-m", "svtp", "-dn", "synthetic", "-cr", ckpt_root,
        "-cn", "smoke", "-e", "1", "-nd", "300", "-ni", "20", "-nb", "50",
        "-ns", "8", "-nvs", "16", "-nh", "1", "-q",
    ])
    ckpt_dir = os.path.join(ckpt_root, "smoke")
    assert glob.glob(os.path.join(ckpt_dir, "*.npz"))
    log = open(os.path.join(ckpt_dir, "train.log")).read()
    assert "nELBO" in log and "Traceback" not in log

    _run_cli(["cls", "ts", "-dn", "synthetic", "-cd", ckpt_dir,
              "-nd", "100", "-nb", "50", "-ns", "64", "-q"])
    test_logs = glob.glob(os.path.join(ckpt_dir, "test", "*.log"))
    assert test_logs
    content = open(test_logs[0]).read()
    assert "ACC:" in content and "Traceback" not in content

    # predict (serving path): class probabilities over the test split, same
    # MC-predictive NLL/ACC estimator as cls ts but through the fitted
    # (hoisted-solves) model.
    _run_cli(["cls", "pr", "-dn", "synthetic", "-cd", ckpt_dir,
              "-nd", "100", "-nb", "50", "-ns", "64", "-q"])
    pred_log = open(os.path.join(ckpt_dir, "predict", "predict.log")).read()
    assert "ACC:" in pred_log and "Traceback" not in pred_log
    preds = np.load(os.path.join(ckpt_dir, "predictions.npz"))
    assert preds["proba"].shape[0] == 100 and preds["label"].shape == (100,)
    np.testing.assert_allclose(preds["proba"].sum(axis=1), 1.0, rtol=1e-4)


@pytest.mark.slow
def test_classification_resize_roundtrip(tmp_path):
    """-r 2 downscales inputs (reference classification/train.py:156-161);
    cls ts must resize test images back to the inducing resolution."""
    ckpt_root = str(tmp_path / "ckpt")
    _run_cli([
        "cls", "tr", "-m", "svgp", "-dn", "synthetic", "-cr", ckpt_root,
        "-cn", "rs", "-e", "1", "-nd", "200", "-ni", "16", "-nb", "50",
        "-ns", "4", "-nvs", "8", "-nh", "1", "-r", "2", "-q",
    ])
    ckpt_dir = os.path.join(ckpt_root, "rs")
    _run_cli(["cls", "ts", "-dn", "synthetic", "-cd", ckpt_dir,
              "-nd", "50", "-nb", "50", "-ns", "16", "-q"])
    test_logs = glob.glob(os.path.join(ckpt_dir, "test", "*.log"))
    assert test_logs and "ACC:" in open(test_logs[0]).read()


@pytest.mark.slow
def test_ensemble_train_then_test(tmp_path):
    ckpt_root = str(tmp_path / "ckpt")
    _run_cli([
        "ens", "tr", "-m", "tp", "-dn", "synthetic", "-cr", ckpt_root,
        "-cn", "smoke", "-e", "1", "-nd", "300", "-nb", "100", "-nh", "1",
        "-nc", "8", "-q",
    ])
    ckpt_dir = os.path.join(ckpt_root, "smoke")
    saves = [f for f in glob.glob(os.path.join(ckpt_dir, "*.npy"))
             if not f.endswith("meta.npy")]
    assert saves, "no ensemble member checkpoint"
    _run_cli(["ens", "ts", "-dn", "synthetic", "-cd", ckpt_dir,
              "-nd", "100", "-q"])


@pytest.mark.slow
def test_ensemble_nh2_checkpoint_roundtrip(tmp_path):
    """nh=2 makes len(params) == len(net_kwargs) == 6: the old np.array save
    recursed into a (2, 6) object array and ens ts crashed unpacking it."""
    ckpt_root = str(tmp_path / "ckpt")
    _run_cli([
        "ens", "tr", "-m", "tp", "-dn", "synthetic", "-cr", ckpt_root,
        "-cn", "smoke2", "-e", "1", "-nd", "200", "-nb", "100", "-nh", "2",
        "-nc", "8", "-q",
    ])
    ckpt_dir = os.path.join(ckpt_root, "smoke2")
    _run_cli(["ens", "ts", "-dn", "synthetic", "-cd", ckpt_dir,
              "-nd", "100", "-q"])


@pytest.mark.slow
def test_ensemble_multi_member_average(tmp_path):
    """ens ts with several -cd run dirs averages member logits
    (reference ensemble/test.py:48-61)."""
    ckpt_root = str(tmp_path / "ckpt")
    dirs = []
    for i, seed in enumerate([10, 11]):
        _run_cli([
            "ens", "tr", "-m", "tp", "-dn", "synthetic", "-cr", ckpt_root,
            "-cn", f"m{i}", "-e", "1", "-nd", "200", "-nb", "100",
            "-nh", "1", "-nc", "8", "-s", str(seed), "-q",
        ])
        dirs.append(os.path.join(ckpt_root, f"m{i}"))
    _run_cli(["ens", "ts", "-dn", "synthetic", "-cd", *dirs,
              "-nd", "100", "-q"])


@pytest.mark.slow
def test_find_both_samplers(tmp_path):
    for sampler in ["scipy", "device"]:
        out = str(tmp_path / sampler)
        _run_cli([
            "reg", "fd", "-dn", "syn-normal", "-cd", out, "-nh", "1",
            "-wsl", "1", "-bsl", "0.3", "-el", "1e-1", "-al", "1", "2",
            "-bl", "1", "-ns", "200", "-smp", sampler, "-q",
        ])
        log = open(os.path.join(out, "train.log")).read()
        assert "Traceback" not in log
        assert "(1.0, 0.3" in log  # argmin tuples reported


@pytest.mark.slow
def test_classification_two_lr_split(tmp_path):
    ckpt_root = str(tmp_path / "ckpt")
    _run_cli([
        "cls", "tr", "-m", "svtp", "-dn", "synthetic", "-cr", ckpt_root,
        "-cn", "lr2", "-e", "1", "-nd", "200", "-ni", "12", "-nb", "50",
        "-ns", "4", "-nvs", "8", "-nh", "1", "-lr2", "1e-3", "-q",
    ])
    log = open(os.path.join(ckpt_root, "lr2", "train.log")).read()
    assert "nELBO" in log and "Traceback" not in log


def test_regression_resume(tmp_path):
    """Interrupt-and-resume: second run continues from the saved step with
    optimizer + LR-schedule state (no reference equivalent; SURVEY.md §5)."""
    ckpt_root = str(tmp_path / "ckpt")
    common = ["reg", "tr", "-m", "gp", "-dn", "syn-normal", "-cr", ckpt_root,
              "-cn", "r", "-vi", "5", "-pi", "5", "-nh", "1", "-eps", "1e-2", "-q"]
    _run_cli(common + ["-t", "10"])
    log1 = open(os.path.join(ckpt_root, "r", "train.log")).read()
    assert os.path.isfile(os.path.join(ckpt_root, "r", "resume.state"))

    _run_cli(common + ["-t", "20", "-rs"])
    log2 = open(os.path.join(ckpt_root, "r", "train.log")).read()
    assert "Resumed from" in log2 and "at step 10" in log2
    assert "[   15]" in log2  # continued past the restart point
    assert "Traceback" not in log2


@pytest.mark.slow
def test_classification_resume(tmp_path):
    ckpt_root = str(tmp_path / "ckpt")
    common = ["cls", "tr", "-m", "svgp", "-dn", "synthetic", "-cr", ckpt_root,
              "-cn", "r", "-nd", "150", "-ni", "10", "-nb", "50", "-ns", "4",
              "-nvs", "8", "-nh", "1", "-q"]
    _run_cli(common + ["-e", "1"])
    assert os.path.isfile(os.path.join(ckpt_root, "r", "resume.state"))
    _run_cli(common + ["-e", "2", "-rs"])
    log = open(os.path.join(ckpt_root, "r", "train.log")).read()
    assert "Resumed from" in log and "at epoch 1" in log
    assert "[  2]" in log and "Traceback" not in log


@pytest.mark.slow
def test_classification_conv_resnet(tmp_path):
    """WideResNet NNGP classifier path (strided residual conv kernel)."""
    ckpt_root = str(tmp_path / "ckpt")
    _run_cli([
        "cls", "tr", "-m", "svgp", "-dn", "synthetic", "-cr", ckpt_root,
        "-cn", "wrn", "-n", "resnet", "-e", "1", "-nd", "120", "-ni", "10",
        "-nb", "40", "-ns", "4", "-nvs", "8", "-nh", "1", "-q",
    ])
    log = open(os.path.join(ckpt_root, "wrn", "train.log")).read()
    assert "nELBO" in log and "Traceback" not in log


def test_classification_myrtle_kernel(tmp_path):
    """Myrtle-CNN NNGP classifier (beyond the reference's cnn/resnet surface):
    -nh is the Myrtle depth, inducing inputs stay frozen at their
    class-proportional init (the optimizer masks them out)."""
    from snngp.utils import load_named

    ckpt_root = str(tmp_path / "ckpt")
    _run_cli([
        "cls", "tr", "-m", "svgp", "-dn", "synthetic", "-cr", ckpt_root,
        "-cn", "myr", "-n", "myrtle", "-e", "1", "-nd", "120", "-ni", "10",
        "-nb", "40", "-ns", "4", "-nvs", "8", "-nh", "5", "-q",
    ])
    ckpt_dir = os.path.join(ckpt_root, "myr")
    log = open(os.path.join(ckpt_dir, "train.log")).read()
    assert "nELBO" in log and "Traceback" not in log
    assert "inducing inputs fixed" in log

    # The inducing inputs must be bit-identical to the class-proportional
    # init (frozen), while the variational params did move.
    params = load_named(os.path.join(ckpt_dir, "001.npz"))
    iv = [v for n, v in params.items() if "inducing_variable" in n]
    assert iv, "no inducing variable in checkpoint"
    from snngp.data.classification import get_train_dataset
    (x_train, y_train), _, (num_class, _, _) = get_train_dataset(
        name="synthetic", root="./data", num_data=120, valid_prop=0.1,
        normalize=True, seed=10)
    label_class = np.array([np.sum(y_train == ci) for ci in range(num_class)])
    num_inducing_class = np.round(
        10 * label_class / label_class.sum()).astype(int).tolist()
    init = np.concatenate(
        [x_train[y_train == ci][:ni]
         for ci, ni in zip(range(num_class), num_inducing_class)], axis=0)
    np.testing.assert_array_equal(np.asarray(iv[0]),
                                  init.astype(np.float32))

    _run_cli(["cls", "ts", "-dn", "synthetic", "-cd", ckpt_dir,
              "-nd", "50", "-nb", "50", "-ns", "16", "-q"])
    test_logs = glob.glob(os.path.join(ckpt_dir, "test", "*.log"))
    assert test_logs and "ACC:" in open(test_logs[0]).read()

    _run_cli(["cls", "pr", "-dn", "synthetic", "-cd", ckpt_dir,
              "-nd", "50", "-nb", "50", "-ns", "16", "-q"])
    preds = np.load(os.path.join(ckpt_dir, "predictions.npz"))
    assert preds["proba"].shape[0] == 50
    np.testing.assert_allclose(preds["proba"].sum(axis=1), 1.0, rtol=1e-4)


def test_classification_myrtle_depth_validation():
    with pytest.raises(ValueError, match="Myrtle depth"):
        _run_cli([
            "cls", "tr", "-m", "svgp", "-dn", "synthetic", "-cr", "/tmp/x",
            "-cn", "bad", "-n", "myrtle", "-e", "1", "-nd", "40", "-ni", "10",
            "-nb", "40", "-ns", "2", "-nvs", "4", "-nh", "3", "-q",
        ])


@pytest.mark.slow
def test_classification_scan_epoch_matches_loop(tmp_path):
    """--scan-epoch runs identical math (incl. PRNG sequence) to the loop."""
    import numpy as np
    from snngp.utils import load_named

    outs = {}
    for tag, extra in [("loop", []), ("scan", ["-sck"])]:
        ckpt_root = str(tmp_path / tag)
        _run_cli([
            "cls", "tr", "-m", "svgp", "-dn", "synthetic", "-cr", ckpt_root,
            "-cn", "r", "-e", "1", "-nd", "230", "-ni", "10", "-nb", "64",
            "-ns", "4", "-nvs", "8", "-nh", "1", "-q", *extra,
        ])
        outs[tag] = load_named(os.path.join(ckpt_root, "r", "001.npz"))
    for name in outs["loop"]:
        # rtol 1e-4: scan vs loop compile to differently-fused XLA programs
        # (fp reassociation); math is identical.
        np.testing.assert_allclose(outs["loop"][name], outs["scan"][name],
                                   rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.slow
def test_classification_mesh_batch_sharding(tmp_path, monkeypatch):
    """cls train with SNNGP_MESH_DEVICES: batch-sharded ELBO on the CPU mesh."""
    monkeypatch.setenv("SNNGP_MESH_DEVICES", "8")
    ckpt_root = str(tmp_path / "ckpt")
    _run_cli([
        "cls", "tr", "-m", "svgp", "-dn", "synthetic", "-cr", ckpt_root,
        "-cn", "mesh", "-e", "1", "-nd", "200", "-ni", "10", "-nb", "64",
        "-ns", "4", "-nvs", "8", "-nh", "1", "-q",
    ])
    log = open(os.path.join(ckpt_root, "mesh", "train.log")).read()
    assert "Mesh: 8 devices" in log
    assert "nELBO" in log and "Traceback" not in log


def test_regression_boston_from_local_cache(tmp_path):
    """BASELINE.md parity golden #1 (boston gp/tp) is runnable offline given
    a cached housing.data (VERDICT r1 item 6)."""
    rows = np.random.RandomState(7).rand(60, 14) + 0.5
    droot = tmp_path / "data" / "boston"
    droot.mkdir(parents=True)
    with open(droot / "housing.data", "w") as f:
        for r in rows:
            f.write(" ".join(f"{v:9.5f}" for v in r) + "\n")
    ckpt_root = str(tmp_path / "ckpt")
    _run_cli([
        "reg", "tr", "-m", "tp", "-dn", "boston", "-dr", str(tmp_path / "data"),
        "-cr", ckpt_root, "-cn", "boston", "-t", "10", "-vi", "5", "-pi", "5",
        "-nh", "1", "-eps", "1e-2", "-q",
    ])
    ckpt_dir = os.path.join(ckpt_root, "boston")
    assert glob.glob(os.path.join(ckpt_dir, "*.npz")), "no checkpoint saved"
    log = open(os.path.join(ckpt_dir, "train.log")).read()
    assert "NLL:" in log and "Traceback" not in log
