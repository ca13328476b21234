"""What the port's entry points and trainers guard, on the CPU: a launch of
several processes without the whole launch contract (or for a path that
runs in one process only) is refused before any model is built, every
trainer and the evaluator set the arithmetic the port is held to (no TF32,
16-bit matmuls summed in f32, deterministic cuDNN), float16 is accepted
wherever the JAX package accepts it (the kernels take it), and the real
ImageNet and the loader's worker pool stay refused.
"""

import io
from contextlib import redirect_stdout

import pytest
import torch

from ps_pytorch_tpu_torch import config, train, train_lm
from ps_pytorch_tpu_torch.models import build_model
from ps_pytorch_tpu_torch.models.layers import Conv3x3
from ps_pytorch_tpu_torch.runtime import (
    Evaluator, MultiSliceTrainer, Trainer, lm_trainer,
)
from ps_pytorch_tpu_torch.runtime import trainer as trainer_mod
from test_torch_train import two_torch_threads  # noqa: F401

CNN_ARGS = ["--network", "LeNet", "--dataset", "synthetic_mnist",
            "--batch-size", "16", "--compute-dtype", "float32",
            "--max-steps", "1", "--eval-freq", "0", "--resume", "false",
            "--device", "cpu"]
LM_ARGS = ["--lm-attention", "flash", "--lm-d-model", "32", "--lm-layers",
           "1", "--lm-heads", "2", "--lm-vocab", "64", "--lm-seq-len", "32",
           "--batch-size", "2", "--max-steps", "1", "--eval-freq", "0",
           "--resume", "false", "--lm-corpus-tokens", "2000", "--device",
           "cpu"]


def _lm_cfg(**kw):
    return config.TrainConfig(**dict(
        network="TransformerLM", eval_freq=0, resume=False, lm_d_model=32,
        lm_layers=1, lm_heads=2, lm_vocab=64, lm_seq_len=32,
        lm_corpus_tokens=2000, batch_size=2), **kw)


@pytest.mark.parametrize("var", ["WORLD_SIZE", "PS_TPU_NUM_PROCESSES"])
@pytest.mark.parametrize("entry", ["train_sync", "train_async", "train_lm"])
def test_a_launch_of_several_processes_raises_before_a_model_is_built(
        entry, var, monkeypatch, tmp_path):
    def built(*args, **kw):
        raise AssertionError("a trainer was built")

    monkeypatch.setattr(trainer_mod.Trainer, "__init__", built)
    monkeypatch.setattr(MultiSliceTrainer, "__init__", built)
    monkeypatch.setattr(lm_trainer.LMTrainer, "__init__", built)
    main, argv = {
        "train_sync": (train.main, CNN_ARGS),
        "train_async": (train.main, CNN_ARGS + ["--mode", "async"]),
        "train_lm": (train_lm.main, LM_ARGS)}[entry]
    argv = argv + ["--train-dir", str(tmp_path / "td")]
    for name in ("WORLD_SIZE", "PS_TPU_NUM_PROCESSES", "PS_TPU_COORDINATOR"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv(var, "2")
    # Every trainer runs one process a rank (the CNN trainer a replica or
    # a slice, the LM a place of its grid): each asks for the rest of the
    # launch contract.
    match = {"WORLD_SIZE": "WORLD_SIZE=2.*tools.launch",
             "PS_TPU_NUM_PROCESSES":
             "PS_TPU_NUM_PROCESSES=2 without PS_TPU_COORDINATOR"}[var]
    out = io.StringIO()
    with pytest.raises(ValueError, match=match):
        with redirect_stdout(out):
            main(argv)
    assert out.getvalue() == ""          # refused before the CONFIG line
    monkeypatch.setenv(var, "1")         # one process: the trainer is built
    with pytest.raises(AssertionError, match="a trainer was built"):
        with redirect_stdout(out):
            main(argv)


@pytest.fixture
def numerics_flags():
    """Sets the five flags to the opposite of the reference's, and puts
    back what they were after the test."""
    flags = (torch.backends.cuda.matmul, "allow_tf32"), \
        (torch.backends.cuda.matmul,
         "allow_fp16_reduced_precision_reduction"), \
        (torch.backends.cuda.matmul,
         "allow_bf16_reduced_precision_reduction"), \
        (torch.backends.cudnn, "allow_tf32"), \
        (torch.backends.cudnn, "deterministic")
    saved = [getattr(mod, name) for mod, name in flags]
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = True
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    yield
    for (mod, name), value in zip(flags, saved):
        setattr(mod, name, value)


@pytest.mark.parametrize("kind", ["sync", "async", "lm", "evaluator"])
def test_building_a_trainer_sets_the_reference_numerics(kind, numerics_flags,
                                                        tmp_path):
    cnn = config.config_from_args(CNN_ARGS[:-2] + [
        "--train-dir", str(tmp_path / "td")])
    if kind == "sync":
        Trainer(cnn, device="cpu", printer=lambda line: None)
    elif kind == "async":
        MultiSliceTrainer(config.config_from_args(
            CNN_ARGS[:-2] + ["--mode", "async", "--train-dir",
                             str(tmp_path / "td")]),
            n_slices=2, device="cpu", printer=lambda line: None)
    elif kind == "lm":
        lm_trainer.LMTrainer(_lm_cfg(train_dir=str(tmp_path / "td")),
                             device="cpu", printer=lambda line: None)
    else:
        Evaluator(str(tmp_path / "td"), device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction \
        is False
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
        is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.deterministic is True


@pytest.mark.parametrize("kw", [
    dict(network="ResNet18", conv_impl="pallas"),
    dict(network="ResNet18", conv_impl="pallas_im2col"),
    dict(network="LeNet", conv_impl="pallas"),
    dict(network="VGG11", dataset="synthetic_cifar100", conv_impl="pallas"),
    dict(network="ResNet50_ImageNet", dataset="synthetic_imagenet_rrc",
         conv_impl="pallas"),
    dict(network="TransformerLM", eval_freq=0, lm_attention="flash"),
])
def test_float16_is_accepted_where_a_kernel_meets_it(kw):
    """As in the JAX package: float16 with the conv kernel builds every
    stride-1 3x3 of the ResNets and VGGs as the kernel's module in f16
    (LeNet has none and ignores conv_impl); the LM trainer computes in f32
    whatever the field says, so flash meets no f16 there."""
    cfg = config.TrainConfig(compute_dtype="float16", **kw)
    assert cfg.compute_dtype == "float16"
    if cfg.network == "TransformerLM":
        assert cfg.lm_attention == "flash"
        return
    model = build_model(cfg.network, cfg.num_classes, cfg.compute_dtype,
                        cfg.conv_impl)
    convs = [m for m in model.modules() if isinstance(m, Conv3x3)]
    assert (len(convs) > 0) == (cfg.network != "LeNet")
    assert all(m.dtype == torch.float16 for m in convs)


@pytest.mark.parametrize("kw", [
    dict(network="ResNet18", conv_impl="xla"),
    dict(network="LeNet"),
    dict(network="TransformerLM", eval_freq=0, lm_attention="full"),
    dict(network="TransformerLM", eval_freq=0, lm_attention="auto"),
])
def test_float16_still_runs_without_a_kernel(kw):
    assert config.TrainConfig(compute_dtype="float16",
                              **kw).compute_dtype == "float16"


@pytest.mark.parametrize("argv,match", [
    (["--dataset", "ImageNet"], "ImageNet.*ROADMAP.md"),
    (["--network", "TransformerLM", "--eval-freq", "0",
      "--loader-workers", "2"], "loader_workers=2.*ROADMAP.md"),
])
def test_the_real_imagenet_and_the_worker_pool_stay_refused(argv, match,
                                                             tmp_path):
    """Both raise before the CONFIG line: the real ImageNet's files are
    not in the repo, and the LM's token loader has no worker pool (the CNN
    loaders' pool runs: tests/test_torch_train.py)."""
    out = io.StringIO()
    with pytest.raises(ValueError, match=match):
        with redirect_stdout(out):
            train.main(["--network", "ResNet50_ImageNet", *argv,
                        "--train-dir", str(tmp_path / "td"), "--device",
                        "cpu"])
    assert out.getvalue() == ""
