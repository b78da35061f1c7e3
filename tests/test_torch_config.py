"""The port's `Config` and flag surface against the JAX package's: the
same argv gives equal fields and equal ``to_json`` (what a checkpoint
embeds), every invalid flag set raises the same exception type with the
same message, and the flags the port cannot serve yet parse and raise
with their ROADMAP item."""

import dataclasses
import json

import pytest

from dgcnn_tpu.config import Config as JaxConfig
from dgcnn_tpu.config import parse_args as jax_parse_args
from dgcnn_tpu_torch.config import Config, parse_args

# argv cases: tests/test_config.py, tests/test_cli_loop.py::
# test_parse_args_parity and the README's quick-start lines
ARGV = {
    "defaults_train": ["train"],
    "cli_loop_parity": ["train", "-io", "h5", "-if", "ev.h5", "-mb", "16", "-k", "10",
                        "-i", "500", "-lr", "0.005", "-mn", "residual-dgcnn",
                        "--edge_filters", "32", "32", "32", "--no_shuffle"],
    "cli_loop_inference": ["inference", "-mp", "w/snap", "-of", "out.h5"],
    "short_cs": ["train", "-cs", "500", "-io", "synthetic"],
    "readme_train": ["train", "-io", "dgb", "-if", "events.dgb", "-mb", "4", "-i", "5000",
                     "-mn", "residual-dgcnn", "-k", "20", "--edge_filters", "64", "64", "64",
                     "64", "64", "64", "-vf", "val_events.h5", "--lr_schedule", "cosine",
                     "--tensorboard", "-wp", "weights/snap", "-ld", "log"],
    "readme_resume": ["train", "-io", "dgb", "-if", "events.dgb", "-mp", "weights/snap"],
    "readme_auto_resume": ["train", "-io", "dgb", "-if", "events.dgb", "--auto_resume"],
    "readme_inference": ["inference", "-io", "dgb", "-if", "events.dgb", "-mp",
                         "weights/snap", "-of", "predictions.h5"],
    "readme_export": ["export", "-mp", "weights/snap", "-np", "4096", "-of", "model.jaxir"],
    "every_train_flag": [
        "train", "-nc", "3", "-ec", "4", "--head_feat_dim", "64", "--head_mlp", "32", "16",
        "--no_global_pool", "--dropout", "0.5", "--bn_momentum", "0.8", "--no_bn_sync",
        "-io", "npz", "-if", "a.npz", "-of", "o.npz", "--val_batches", "2",
        "--data_key", "d", "--label_key", "l", "--weight_key", "w", "-np", "512",
        "--buckets", "4096", "256", "--prefetch", "0", "--crop_mode", "stride", "--seed", "9",
        "--debug", "--profile_dir", "p", "--no_pallas", "--knn_every", "2",
        "--knn_window", "64", "--block_convs", "2", "--head_factorized", "--head_stream", "on",
        "--block_scan", "off", "--block_impl", "edge", "-rs", "7", "-opt", "momentum",
        "--lr_decay_steps", "5", "--lr_decay_rate", "0.3", "--class_weights", "1", "2", "3",
        "--grad_clip", "0.5", "--max_to_keep", "3", "--augment", "-ps", "1", "-nd", "1"],
    "inference_iteration": ["inference", "-mp", "x.ckpt", "-i", "7", "--ring_impl", "rdma"],
    # parse, then raise item 10 when the model is built
    "not_ported_precision": ["train", "--precision", "bfloat16", "--remat"],
}


@pytest.mark.parametrize("case", sorted(ARGV))
def test_parse_args_matches_jax(case):
    argv = ARGV[case]
    got, want = parse_args(argv), jax_parse_args(argv)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.to_json() == want.to_json()
    assert got.summary() == want.summary()
    assert json.dumps(vars(got), default=list) == json.dumps(vars(want), default=list)
    if case != "readme_export":
        got.validate()
        want.validate()


def test_field_set_and_order_match_jax():
    assert [f.name for f in dataclasses.fields(Config)] == [
        f.name for f in dataclasses.fields(JaxConfig)]
    assert dataclasses.asdict(Config()) == dataclasses.asdict(JaxConfig())


INVALID = {
    # tests/test_config.py::test_validate_rejects
    "kvalue0": dict(kvalue=0),
    "kvalue_exceeds": dict(kvalue=50, num_point=20),
    "minibatch0": dict(minibatch_size=0),
    "num_class1": dict(num_class=1),
    "point_shards0": dict(point_shards=0),
    "inference_without_model": dict(command="inference"),
    # test_config_enum_values_validated, test_class_weights_values_validated
    "precision_typo": dict(precision="bf16"),
    "lr_schedule_typo": dict(lr_schedule="linear"),
    "io_type_typo": dict(io_type="parquet"),
    "crop_typo": dict(crop_mode="first"),
    "optimizer_typo": dict(optimizer="lamb"),
    "block_impl_typo": dict(block_impl="slow"),
    "class_weights_negative": dict(class_weights=(1.0, -2.0)),
    "class_weights_zero": dict(class_weights=(0.0, 1.0)),
    "class_weights_strings": dict(class_weights=("1.0", "2.0")),
    "class_weights_count": dict(class_weights=(1.0, 2.0, 3.0)),
    "early_stop_negative": dict(early_stop_patience=-1),
    "early_stop_without_val": dict(early_stop_patience=2),
    "knn_every0": dict(knn_every=0),
    "knn_window_negative": dict(knn_window=-1),
    "knn_window_below_k": dict(knn_window=8, kvalue=20),
    "block_convs0": dict(block_convs=0),
    "head_factorized_without_mlp": dict(head_factorized=True, head_mlp=()),
    "export_without_model": dict(command="export"),
    "export_without_output": dict(command="export", model_path="m"),
    "export_without_num_point": dict(command="export", model_path="m", output_file="o"),
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_invalid_configs_raise_like_jax(case):
    kw = {"num_class": 2, "edge_filters": (8,), **INVALID[case]}
    with pytest.raises(Exception) as want:
        JaxConfig(**kw).validate()
    with pytest.raises(Exception) as got:
        Config(**kw).validate()
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("argv,item", [
    (["train", "-nd", "4", "-ps", "2", "-np", "256"], "13"),
    (["train", "-ps", "2", "--knn_window", "64", "-np", "256"], "13"),
])
def test_unported_flags_raise_their_item(argv, item):
    jax_parse_args(argv)  # the JAX package takes them
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        parse_args(argv)


@pytest.mark.parametrize("argv,data", [
    (["train", "-nd", "2"], 2),
    (["train", "-nd", "4", "--no_bn_sync"], 4),
    (["inference", "-nd", "2", "-ps", "2", "-np", "256"], 1),
])
def test_num_devices_parses_to_a_data_axis(argv, data):
    """``-nd`` has the JAX meaning: the ranks in all, ``num_devices /
    point_shards`` of them on the data axis."""
    from dgcnn_tpu_torch.parallel.mesh import make_mesh

    want, got = jax_parse_args(argv), parse_args(argv)
    assert (got.num_devices, got.point_shards, got.bn_sync) == (
        want.num_devices, want.point_shards, want.bn_sync)
    assert make_mesh(got.num_devices, got.point_shards) == {"data": data,
                                                          "points": got.point_shards}


def test_precision_and_remat_raise_item_10_when_built():
    from dgcnn_tpu_torch.train.trainval import Trainval

    for argv in (["train", "--precision", "bfloat16"], ["train", "--remat"]):
        cfg = parse_args(argv + ["--edge_filters", "8", "--head_feat_dim", "8"])
        with pytest.raises(NotImplementedError, match="item 10"):
            Trainval(cfg, device="cpu")


def test_help_exits_zero(capsys):
    with pytest.raises(SystemExit) as e:
        parse_args(["train", "--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "KVALUE" in out and "--kvalue" in out and "-k" in out


def test_config_file_defaults_and_cli_override(tmp_path):
    """tests/test_config.py's --config cases, against the JAX parser."""
    cfgfile = tmp_path / "run.json"
    cfgfile.write_text(json.dumps({
        "kvalue": 11, "minibatch_size": 16, "model_name": "residual-dgcnn",
        "edge_filters": [32, 32, 32], "knn_every": 3,
    }))
    argv = ["train", "-c", str(cfgfile), "-io", "synthetic", "-mb", "4"]
    got = parse_args(argv)
    assert dataclasses.asdict(got) == dataclasses.asdict(jax_parse_args(argv))
    assert got.kvalue == 11 and got.minibatch_size == 4 and got.edge_filters == (32, 32, 32)

    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"no_such_flag": 1}))
    with pytest.raises(SystemExit, match="unknown keys"):
        parse_args(["train", "-c", str(bad)])
    with pytest.raises(SystemExit, match="must be passed"):
        parse_args(["train", f"-c{cfgfile}", "-io", "synthetic"])
    with pytest.raises(SystemExit, match="requires a file path"):
        parse_args(["train", "-c"])


def test_checkpoint_config_reloads_and_iteration_is_train_only(tmp_path, capsys):
    cfg0 = Config(num_class=3, kvalue=9, edge_filters=(8, 8), minibatch_size=2,
                  io_type="synthetic", knn_every=2, iteration=10000)
    p = tmp_path / "saved.json"
    p.write_text(cfg0.to_json())
    for argv in (["train", "-c", str(p)], ["inference", "-c", str(p), "-mp", "x.ckpt"],
                 [f"--config={p}", "train"]):
        got, want = parse_args(argv), jax_parse_args(argv)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.kvalue == 9 and got.edge_filters == (8, 8) and got.knn_every == 2
    assert parse_args(["inference", "-c", str(p), "-mp", "x.ckpt"]).iteration == 0
    assert "skipping train-only key 'iteration'" in capsys.readouterr().out


def test_info_subcommand(capsys):
    from dgcnn_tpu_torch.cli import main

    assert main(["info"]) == 0
    out = capsys.readouterr().out
    for word in ("dgcnn_tpu_torch", "torch", "device", "kernels", "native IO"):
        assert word in out


def test_cli_rejects_invalid_flags_with_exit_2(capsys):
    from dgcnn_tpu_torch.cli import main

    assert main(["train", "-k", "0"], device="cpu") == 2
    assert "error: KVALUE must be >= 1" in capsys.readouterr().err


def test_export_raises_item_14(tmp_path):
    from dgcnn_tpu_torch.cli import main

    with pytest.raises(NotImplementedError, match="item 14"):
        main(["export", "-mp", "m", "-of", "o", "-np", "128"], device="cpu")
