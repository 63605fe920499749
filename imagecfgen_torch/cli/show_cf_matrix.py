"""Print the 10x10 counterfactual difficulty matrix that
``make_mnist_cf_matrix`` wrote (port of ``show_cf_matrix.py``).

    python -m imagecfgen_torch.cli.show_cf_matrix [--matrix mnist-cf-matrix.pkl] \
        [--metric mixture|mse|ssim]

``--metric`` checks that the pickle was built with that metric. It reads a
pickle and touches no tensor, so it takes no ``--device``.
"""
from argparse import ArgumentParser
import pickle
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--matrix", type=str, default="mnist-cf-matrix.pkl")
parser.add_argument("--metric", type=str, default=None,
                    help="metric the matrix was built with (sanity check; "
                         "the pkl stores one matrix per build)")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import numpy as np

    with open(args.matrix, "rb") as f:
        data = pickle.load(f)
    matrix = data["matrix"] if isinstance(data, dict) else data
    if args.metric and isinstance(data, dict):
        built = data.get("metric", "mixture")
        if built != args.metric:
            raise SystemExit(
                f"{args.matrix} was built with metric={built!r}; rebuild with "
                f"make_mnist_cf_matrix.py --metric {args.metric}"
            )

    header = "src\\tgt " + " ".join(f"{t:>6d}" for t in range(10))
    print(header)
    print("-" * len(header))
    for src in range(10):
        cells = []
        for tgt in range(10):
            v = matrix[src, tgt]
            cells.append("     -" if np.isnan(v) else f"{v:6.3f}")
        print(f"{src:>7d} " + " ".join(cells))
    print("\n(minimal class-mixture weight that flips the classifier; lower = easier)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
