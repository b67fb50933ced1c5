"""Table-only FT-Transformer baseline, the port's counterpart of
``ft_table.py``: train a tabular classifier on the clinical CSV alone.

    python -m gfe_mamba_torch.cli.ft_table --table_path <csv> [--epochs 50]
        [--dim 32] [--depth 6] [--heads 8] [--batch 64] [--split 0.8]
        [--lr 1e-4] [--seed 0] [--log_every 10] [--device cpu]

The same arguments, rows and printed lines as the JAX script: rows
without a LABEL are dropped; the train/test split and every epoch's
order come from ``np.random.RandomState(seed)``, so both scripts train
and test on the same rows in the same order; the model starts from
flax's init law drawn from ``seed``; Adam, BCE with logits, full batches
only; every ``log_every`` epochs and at the last it prints ``epoch <n>:
loss=... acc=... f1=... mcc=...`` on the test rows.  Runs on the GPU
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from gfe_mamba_torch import resolve_device
from gfe_mamba_torch.data.table import Table, prepare_table, read_csv
from gfe_mamba_torch.models.dropout import seed_dropout
from gfe_mamba_torch.models.ft_transformer import FTTransformer
from gfe_mamba_torch.training.metrics import binary_metrics
from gfe_mamba_torch.utils.initializers import init_weights


def labelled_rows(table: Table) -> Table:
    """The rows whose LABEL is present (``df[~df["LABEL"].isna()]``)."""
    label = table.data["LABEL"]
    if isinstance(label, list):
        keep = np.asarray([v is not None for v in label])
    else:
        keep = ~np.isnan(label) if label.dtype.kind == "f" \
            else np.ones(len(label), bool)
    return Table(table.columns, {
        name: [v for v, k in zip(col, keep) if k] if isinstance(col, list)
        else col[keep] for name, col in table.data.items()})


def main(args) -> dict:
    """Train; returns the split (``train_rows``, ``test_rows``), each
    epoch's batches of rows and the printed lines."""
    device = resolve_device(args.device)
    table = labelled_rows(read_csv(args.table_path))
    prepared = prepare_table(table)
    labels = np.asarray(table.data["LABEL"]).astype(int)
    cate, conti = prepared["cate_x"], prepared["conti_x"]

    rng = np.random.RandomState(args.seed)
    order = rng.permutation(len(labels))
    cut = int(len(order) * args.split)
    tr, te = order[:cut], order[cut:]

    model = FTTransformer(prepared["num_cat"], prepared["num_cont"],
                          dim=args.dim, depth=args.depth, heads=args.heads,
                          dim_head=max(args.dim // args.heads, 8))
    init_weights(model, torch.Generator().manual_seed(args.seed), "flax")
    model.to(device)
    seed_dropout(model, torch.Generator(device=device).manual_seed(
        args.seed + 1))
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr)

    def inputs(rows):
        return (torch.from_numpy(cate[rows]).to(device),
                torch.from_numpy(conti[rows]).to(device))

    batches, lines = [], []
    for epoch in range(args.epochs):
        perm = rng.permutation(len(tr))
        losses, epoch_batches = [], []
        model.train()
        for start in range(0, len(perm) - args.batch + 1, args.batch):
            idx = tr[perm[start:start + args.batch]]
            epoch_batches.append(idx)
            y = torch.from_numpy(labels[idx].astype(np.float32)).to(device)
            loss = F.binary_cross_entropy_with_logits(
                model(*inputs(idx)).squeeze(-1), y)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
            losses.append(float(loss.detach()))
        batches.append(epoch_batches)
        if (epoch + 1) % args.log_every == 0 or epoch == args.epochs - 1:
            model.eval()
            with torch.no_grad():
                probs = torch.sigmoid(model(*inputs(te)).squeeze(-1))
            m = binary_metrics(probs.cpu(), torch.from_numpy(labels[te]))
            line = (f"epoch {epoch + 1}: loss={np.mean(losses):.4f} "
                    f"acc={float(m.accuracy):.4f} f1={float(m.f1):.4f} "
                    f"mcc={float(m.mcc):.4f}")
            print(line, flush=True)
            lines.append(line)
    return dict(train_rows=tr, test_rows=te, batches=batches, lines=lines,
                model=model)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Table-only FT-Transformer baseline (PyTorch port)")
    parser.add_argument("--table_path", required=True)
    parser.add_argument("--epochs", type=int, default=50)
    parser.add_argument("--dim", type=int, default=32)
    parser.add_argument("--depth", type=int, default=6)
    parser.add_argument("--heads", type=int, default=8)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--split", type=float, default=0.8)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log_every", type=int, default=10)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; the GPU when omitted (raises "
                             "without one), 'cpu' for the CPU")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
