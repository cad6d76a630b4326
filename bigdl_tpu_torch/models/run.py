"""Training entry point of the port (counterpart of
``bigdl_tpu/models/run.py``'s ``transformer-train`` subcommand, single
device):

    python -m bigdl_tpu_torch.models.run transformer-train \\
        --size small --vocab 32000 --seq-len 1024 -b 8 --maxIteration 8

TransformerLM on the synthetic next-token corpus, trained by
``Optimizer(...).optimize()`` with
``TimeDistributedCriterion(FusedSoftmaxCrossEntropyCriterion())`` and
Adam.  The flags and defaults are the JAX recipe's (``--syncEvery k``:
read the loss every k-th step only; ``--checkpoint DIR``: a snapshot
under DIR at every epoch's end, ``set_checkpoint(DIR,
Trigger.every_epoch())``, which the JAX package's recipe also resumes
from), plus ``--device`` (default: the CUDA card; ``--device cpu`` runs
the kernels' plain versions).  ``--scanLayers auto|on|off`` holds the
blocks scanned (auto: "medium" and "large", as in JAX) and
``--rematPolicy NAME`` rematerialises each block in training under a
JAX policy name (checked before any data is built).  ``--sp``/``--pp``
above 1 raise: the model-parallel engines are not ported yet; the JAX
recipe's summary and prefetch flags wait for ROADMAP A1.
"""

import argparse
import logging
import os
import sys


def _validate_remat_policy(args):
    """Fail on an unknown ``--rematPolicy`` NAME before any data is built,
    with the list of valid names."""
    from bigdl_tpu_torch.nn.containers import resolve_checkpoint_policy

    return resolve_checkpoint_policy(getattr(args, "remat_policy", None))


def cmd_transformer_train(args):
    """TransformerLM on a synthetic next-token corpus, one device."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
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
    dataset = array_dataset(x, y) >> SampleToMiniBatch(args.batch)
    opt = optim.Optimizer(model, dataset, crit,
                          optim.Adam(learning_rate=args.lr),
                          device=args.device)
    opt.set_end_when(optim.Trigger.max_epoch(args.max_epoch)
                     if args.max_iteration is None
                     else optim.Trigger.max_iteration(args.max_iteration))
    if args.sync_every != 1:
        opt.set_sync_every(args.sync_every)
    if args.checkpoint:
        opt.set_checkpoint(args.checkpoint, optim.Trigger.every_epoch())
    opt.optimize()
    return opt


def main(argv=None):
    logging.basicConfig(
        level=os.environ.get("BIGDL_LOG_LEVEL", "INFO").upper(),
        format="%(asctime)s %(levelname)-5s %(message)s")
    parser = argparse.ArgumentParser(prog="bigdl_tpu_torch.models.run")
    sub = parser.add_subparsers(dest="command", required=True)
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
