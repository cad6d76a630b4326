"""Training entry points of the port (counterpart of
``bigdl_tpu/models/run.py``), on one device or data-parallel:

    python -m bigdl_tpu_torch.models.run lenet-train -b 64
    python -m bigdl_tpu_torch.models.run lenet-test
    python -m bigdl_tpu_torch.models.run vgg-train -b 128
    python -m bigdl_tpu_torch.models.run resnet-train -b 128 --depth 20
    python -m bigdl_tpu_torch.models.run resnet-imagenet-train -b 128 \\
        --maxIteration 8
    python -m bigdl_tpu_torch.models.run inception-train --version v2
    python -m bigdl_tpu_torch.models.run transformer-train \\
        --size small --vocab 32000 --seq-len 1024 -b 8 --maxIteration 8
    torchrun --nproc-per-node 4 -m bigdl_tpu_torch.models.run \\
        resnet-train -b 128 --distributed

Each trains through ``Optimizer(...).optimize()`` with the JAX recipe's
model, criterion, method, flags and defaults, on the JAX recipe's
synthetic data (the same numpy draws: ``_synthetic_images``,
``synthetic_mnist``), plus ``--device`` (default: the CUDA card;
``--device cpu`` runs the kernels' plain versions).  ``--checkpoint DIR``
writes a snapshot under DIR at every epoch's end
(``set_checkpoint(DIR, Trigger.every_epoch())``), which either package
resumes; ``--syncEvery k`` reads the loss every k-th step only;
``--summaryDir D`` (with ``--appName``) writes TensorBoard summaries
under ``D/<appName>/train`` (``visualization.TrainSummary``);
``--numWorkers N`` runs the transformer chain on N prefetch workers
ahead of the loop (``dataset.prefetch``, ``--queueDepth`` batches held
ready).

``--distributed`` trains through ``DistriOptimizer`` (ZeRO-1 over the
``torch.distributed`` group that ``utils.engine.Engine`` joins from
``BIGDL_COORDINATOR`` / torchrun's variables, or a world of one), in
every recipe whose JAX counterpart routes it; ``lenet-test`` runs no
optimizer and refuses it.

Refused, each naming its ROADMAP item: ``--folder`` (dataset sources,
A9), ``--model`` (the serializer, A9), ``--distributed`` for
``lenet-test`` (A4), and for ``transformer-train`` ``--sp``/``--pp``
above 1 (A7).
``--compilationCache`` names JAX's XLA cache: the port has no
counterpart (its CUDA graphs are captured per run) and ignores it.

``transformer-train``: TransformerLM on the synthetic next-token corpus
with ``TimeDistributedCriterion(FusedSoftmaxCrossEntropyCriterion())``
and Adam; ``--scanLayers auto|on|off`` holds the blocks scanned (auto:
"medium" and "large", as in JAX) and ``--rematPolicy NAME``
rematerialises each block in training under a JAX policy name (checked
before any data is built).  ``resnet-imagenet-train``: ResNet-50 with the
published schedule (5-epoch linear warm-up from ``--learningRate`` to
``--maxLr``, 0.1x at epochs 30/60/80 of 1281167 images), ``--remat``,
``--rematPolicy``, ``--s2d`` and ``--fused``.
"""

import argparse
import logging
import os
import sys

import numpy as np


def _refuse_unported(args):
    """The JAX recipe flags whose machinery the port does not have yet."""
    refused = [
        ("folder", "--folder: data folders need the dataset sources "
                   "(MNIST/CIFAR/ImageNet readers), not ported yet "
                   "(ROADMAP A9)"),
        ("model", "--model: loading a saved module needs the serializer, "
                  "not ported yet (ROADMAP A9)"),
    ]
    for attr, why in refused:
        if getattr(args, attr, None):
            raise NotImplementedError(why)
    if getattr(args, "compilation_cache", None):
        logging.getLogger("bigdl_tpu_torch").warning(
            "--compilationCache names JAX's XLA cache; the port captures "
            "its CUDA graphs per run and ignores it")


def synthetic_mnist(n: int = 2048, num_classes: int = 10, seed: int = 7):
    """Separable digits, one Gaussian bump a class plus noise (the JAX
    package's ``dataset/mnist.synthetic_mnist``, the same numpy draws)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, n).astype(np.int32)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)
    images = np.empty((n, 28, 28), np.float32)
    for c in range(num_classes):
        cy, cx = 6 + 3 * (c // 5) * 4, 4 + (c % 5) * 5
        bump = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0)
        mask = labels == c
        k = int(mask.sum())
        images[mask] = bump[None] + 0.3 * rng.standard_normal(
            (k, 28, 28)).astype(np.float32)
    return np.clip(images, 0.0, 1.0), labels


def _mnist(n):
    """Train and held-out synthetic MNIST splits (the last quarter held
    out), as the JAX recipe makes them without a folder."""
    x, y = synthetic_mnist(n)
    k = n - n // 4
    return (x[:k], y[:k]), (x[k:], y[k:])


def _synthetic_images(n, h, w, c, classes, seed=11):
    """NHWC images with a class-dependent mean shift (the JAX recipe's,
    the same numpy draws)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, size=n)
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    # class-dependent mean shift so accuracy can move off chance
    x += ((y[:, None, None, None] + 1) / classes).astype(np.float32)
    return x, y


def _to_dataset(x, y, batch):
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
    return array_dataset(x, y) >> SampleToMiniBatch(batch)


def _build_optimizer(args, model, train_ds, val_ds, criterion, method,
                     val_methods):
    """``Optimizer`` with the JAX recipe's prefetch workers, route
    (``--distributed``: ``DistriOptimizer`` over the process group of
    ``utils.engine.Engine``, a world of one when none is initialized),
    end trigger, sync cadence, validation every epoch, checkpoint every
    epoch and train summary (JAX :55-82)."""
    from bigdl_tpu_torch.optim import Optimizer, Trigger

    if getattr(args, "num_workers", 0):
        train_ds = train_ds.prefetch(num_workers=args.num_workers,
                                     queue_depth=args.queue_depth)
    opt = Optimizer(model, train_ds, criterion, method,
                    distributed=args.distributed, device=args.device)
    opt.set_end_when(Trigger.max_epoch(args.max_epoch)
                     if args.max_iteration is None
                     else Trigger.max_iteration(args.max_iteration))
    if args.sync_every != 1:
        opt.set_sync_every(args.sync_every)
    if val_ds is not None and val_methods:
        opt.set_validation(Trigger.every_epoch(), val_ds, val_methods)
    if args.checkpoint:
        opt.set_checkpoint(args.checkpoint, Trigger.every_epoch())
    if args.summary_dir:
        from bigdl_tpu_torch.visualization import TrainSummary

        opt.set_train_summary(TrainSummary(args.summary_dir, args.app_name))
    return opt


def cmd_lenet_train(args):
    """LeNet-5 on synthetic MNIST: SGD(momentum 0.9), ClassNLL, Top1 on
    the held-out quarter every epoch."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.models.lenet import LeNet5

    _refuse_unported(args)
    (xtr, ytr), (xte, yte) = _mnist(args.synth_n)
    opt = _build_optimizer(
        args, LeNet5(device=args.device), _to_dataset(xtr, ytr, args.batch),
        _to_dataset(xte, yte, args.batch), nn.ClassNLLCriterion(),
        optim.SGD(learning_rate=args.lr, momentum=0.9, dampening=0.0),
        [optim.Top1Accuracy()])
    opt.optimize()
    return opt


def cmd_lenet_test(args):
    """Top1 and Top5 of a LeNet-5 (fresh weights: ``--model`` waits for
    the serializer) on the held-out synthetic split; returns the
    results."""
    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.models.lenet import LeNet5

    _refuse_unported(args)
    if args.distributed:
        raise NotImplementedError(
            "--distributed: lenet-test evaluates on one device; the JAX "
            "recipe routes no optimizer here and the port has no "
            "data-parallel evaluation (ROADMAP A4)")
    _, (xte, yte) = _mnist(args.synth_n)
    results = optim.validate(LeNet5(device=args.device),
                             _to_dataset(xte, yte, args.batch),
                             [optim.Top1Accuracy(), optim.Top5Accuracy()])
    for r in results:
        print(r)
    return results


def _cifar_split(args):
    x, y = _synthetic_images(args.synth_n, 32, 32, 3, 10)
    holdout = max(1, min(256, len(x) // 4))
    return (_to_dataset(x[:-holdout], y[:-holdout], args.batch),
            _to_dataset(x[-holdout:], y[-holdout:], args.batch))


def cmd_vgg_train(args):
    """VggForCifar10 on synthetic CIFAR: SGD(momentum 0.9, weight decay
    5e-4), ClassNLL, Top1 on the held-out images every epoch."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.models.vgg import VggForCifar10

    _refuse_unported(args)
    train, val = _cifar_split(args)
    opt = _build_optimizer(
        args, VggForCifar10(device=args.device), train, val,
        nn.ClassNLLCriterion(),
        optim.SGD(learning_rate=args.lr, momentum=0.9, dampening=0.0,
                  weight_decay=5e-4),
        [optim.Top1Accuracy()])
    opt.optimize()
    return opt


def cmd_resnet_train(args):
    """ResNetCifar(``--depth``) on synthetic CIFAR: SGD(nesterov, momentum
    0.9, weight decay 1e-4), CrossEntropy, Top1 every epoch."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.models.resnet import ResNetCifar

    _refuse_unported(args)
    train, val = _cifar_split(args)
    opt = _build_optimizer(
        args, ResNetCifar(depth=args.depth, device=args.device), train, val,
        nn.CrossEntropyCriterion(),
        optim.SGD(learning_rate=args.lr, momentum=0.9, dampening=0.0,
                  weight_decay=1e-4, nesterov=True),
        [optim.Top1Accuracy()])
    opt.optimize()
    return opt


def cmd_resnet_imagenet_train(args):
    """ResNet-50 with the published ImageNet recipe (global batch 8192,
    90 epochs, 5-epoch linear warm-up from ``--learningRate`` to
    ``--maxLr``, then 0.1x at epochs 30/60/80; SGD momentum 0.9, weight
    decay 1e-4), the epoch counted over ImageNet's 1281167 images, on
    synthetic 224 x 224 images."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.models.resnet import ResNet

    remat_policy = _validate_remat_policy(args)
    _refuse_unported(args)
    n_train = 1281167
    steps_per_epoch = max(int(np.ceil(n_train / args.batch)), 1)
    warmup_iteration = steps_per_epoch * 5
    delta = (args.max_lr - args.lr) / warmup_iteration
    x, y = _synthetic_images(max(args.synth_n // 4, args.batch * 2),
                             224, 224, 3, 1000)
    model = ResNet(depth=50, class_num=1000, remat=args.remat,
                   stem_s2d=args.s2d, remat_policy=remat_policy,
                   device=args.device)
    method = optim.SGD(
        learning_rate=args.lr, momentum=0.9, dampening=0.0,
        weight_decay=1e-4,
        learning_rate_schedule=optim.EpochDecayWithWarmUp(
            warmup_iteration, delta, steps_per_epoch))
    if args.fused:
        method = optim.Fused(method)
    opt = _build_optimizer(args, model, _to_dataset(x, y, args.batch), None,
                           nn.CrossEntropyCriterion(), method,
                           [optim.Top1Accuracy()])
    opt.optimize()
    return opt


def cmd_inception_train(args):
    """Inception v1 (no aux heads) or v2 on synthetic 224 x 224 images:
    SGD(momentum 0.9), ClassNLL."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.models.inception import (InceptionV1NoAuxClassifier,
                                                  InceptionV2)

    _refuse_unported(args)
    x, y = _synthetic_images(max(args.synth_n // 8, args.batch * 2),
                             224, 224, 3, args.classes)
    build = InceptionV2 if args.version == "v2" \
        else InceptionV1NoAuxClassifier
    opt = _build_optimizer(
        args, build(args.classes, device=args.device),
        _to_dataset(x, y, args.batch), None, nn.ClassNLLCriterion(),
        optim.SGD(learning_rate=args.lr, momentum=0.9, dampening=0.0), [])
    opt.optimize()
    return opt


def _validate_remat_policy(args):
    """Fail on an unknown ``--rematPolicy`` NAME before any data is built,
    with the list of valid names."""
    from bigdl_tpu_torch.nn.containers import resolve_checkpoint_policy

    return resolve_checkpoint_policy(getattr(args, "remat_policy", None))


def cmd_transformer_train(args):
    """TransformerLM on a synthetic next-token corpus, one device."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.models.transformer import (synthetic_corpus,
                                                    transformer_lm)

    remat_policy = _validate_remat_policy(args)
    if args.sp > 1 or args.pp > 1:
        raise NotImplementedError(
            "--sp/--pp: the sequence- and pipeline-parallel engines are not "
            "ported yet (ROADMAP A7)")
    scan = {"auto": None, "on": True, "off": False}[args.scan_layers]
    x, y = synthetic_corpus(args.synth_n, args.seq_len, args.vocab)
    model = transformer_lm(args.size, args.vocab, max_len=args.seq_len,
                           device=args.device, scan_layers=scan,
                           remat_policy=remat_policy)
    crit = nn.TimeDistributedCriterion(
        nn.FusedSoftmaxCrossEntropyCriterion())
    opt = _build_optimizer(args, model, _to_dataset(x, y, args.batch), None,
                           crit, optim.Adam(learning_rate=args.lr), [])
    opt.optimize()
    return opt


def _common_flags(p, default_epochs):
    """The JAX recipes' common flags and defaults, plus ``--device``."""
    p.add_argument("-f", "--folder", default=None,
                   help="data folder (refused: ROADMAP A9)")
    p.add_argument("-b", "--batchSize", type=int, default=64, dest="batch")
    p.add_argument("--learningRate", type=float, default=0.05, dest="lr")
    p.add_argument("--maxEpoch", type=int, default=default_epochs,
                   dest="max_epoch")
    p.add_argument("--maxIteration", type=int, default=None,
                   dest="max_iteration")
    p.add_argument("--checkpoint", default=None,
                   help="directory of a snapshot at every epoch's end")
    p.add_argument("--summaryDir", default=None, dest="summary_dir",
                   help="TensorBoard summaries under DIR/<appName>/train")
    p.add_argument("--appName", default="bigdl_tpu", dest="app_name")
    p.add_argument("--distributed", action="store_true",
                   help="DistriOptimizer over the process group")
    p.add_argument("--model", default=None,
                   help="snapshot to load (refused: ROADMAP A9)")
    p.add_argument("--synthN", type=int, default=2048, dest="synth_n")
    _prefetch_flags(p)
    p.add_argument("--syncEvery", type=int, default=1, dest="sync_every",
                   help="block on the device loss every k-th step only")
    p.add_argument("--compilationCache", default=None,
                   dest="compilation_cache", metavar="DIR",
                   help="JAX's XLA cache; ignored by the port")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the kernels' plain versions)")


def _prefetch_flags(p):
    p.add_argument("--numWorkers", type=int, default=0, dest="num_workers",
                   help="prefetch transform workers (0 = synchronous)")
    p.add_argument("--queueDepth", type=int, default=4, dest="queue_depth",
                   help="prefetch queue depth (batches held ahead)")


#: subcommand -> (function, default epochs, extra flags): JAX's table
CNN_RECIPES = {
    "lenet-train": (cmd_lenet_train, 5, []),
    "lenet-test": (cmd_lenet_test, 1, []),
    "vgg-train": (cmd_vgg_train, 2, []),
    "resnet-train": (cmd_resnet_train, 2,
                     [("--depth", dict(type=int, default=20))]),
    "resnet-imagenet-train": (
        cmd_resnet_imagenet_train, 90,
        [("--maxLr", dict(type=float, default=3.2, dest="max_lr")),
         ("--fused", dict(action="store_true",
                          help="flat fused optimizer update")),
         ("--remat", dict(action="store_true",
                          help="rematerialise residual blocks")),
         ("--rematPolicy", dict(default=None, dest="remat_policy",
                                metavar="NAME",
                                help="remat policy name for the block "
                                     "wrappers (implies --remat)")),
         ("--s2d", dict(action="store_true",
                        help="space-to-depth 7x7 stem"))]),
    "inception-train": (cmd_inception_train, 1,
                        [("--version", dict(default="v1",
                                            choices=["v1", "v2"])),
                         ("--classes", dict(type=int, default=100))]),
}


def main(argv=None):
    logging.basicConfig(
        level=os.environ.get("BIGDL_LOG_LEVEL", "INFO").upper(),
        format="%(asctime)s %(levelname)-5s %(message)s")
    parser = argparse.ArgumentParser(prog="bigdl_tpu_torch.models.run")
    sub = parser.add_subparsers(dest="command", required=True)
    for name, (fn, epochs, extra) in CNN_RECIPES.items():
        p = sub.add_parser(name)
        _common_flags(p, epochs)
        for flag, kw in extra:
            p.add_argument(flag, **kw)
        p.set_defaults(fn=fn)
    p = sub.add_parser("transformer-train")
    p.add_argument("-b", "--batchSize", type=int, default=64, dest="batch")
    p.add_argument("--learningRate", type=float, default=1e-3, dest="lr")
    p.add_argument("--maxEpoch", type=int, default=1, dest="max_epoch")
    p.add_argument("--maxIteration", type=int, default=None,
                   dest="max_iteration")
    p.add_argument("--synthN", type=int, default=2048, dest="synth_n")
    p.add_argument("--syncEvery", type=int, default=1, dest="sync_every",
                   help="block on the device loss every k-th step only")
    p.add_argument("--checkpoint", default=None,
                   help="directory of a snapshot at every epoch's end")
    p.add_argument("--summaryDir", default=None, dest="summary_dir",
                   help="TensorBoard summaries under DIR/<appName>/train")
    p.add_argument("--appName", default="bigdl_tpu", dest="app_name")
    p.add_argument("--distributed", action="store_true",
                   help="DistriOptimizer over the process group")
    _prefetch_flags(p)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--seq-len", type=int, default=64, dest="seq_len")
    p.add_argument("--size", default="tiny",
                   choices=["tiny", "small", "medium", "large"])
    p.add_argument("--scanLayers", default="auto",
                   choices=["auto", "on", "off"], dest="scan_layers",
                   help="hold the blocks scanned, one stacked 'blocks' "
                        "entry (auto: on for medium/large)")
    p.add_argument("--rematPolicy", default=None, dest="remat_policy",
                   metavar="NAME",
                   help="remat policy applied per transformer block (a "
                        "jax.checkpoint_policies name, e.g. dots_saveable, "
                        "nothing_saveable)")
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--pp", type=int, default=1)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the kernels' plain versions)")
    p.set_defaults(fn=cmd_transformer_train)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
