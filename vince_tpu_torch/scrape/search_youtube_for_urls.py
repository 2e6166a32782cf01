"""Search YouTube for category videos into train and val id CSVs
(counterpart of ``vince_tpu/scrape/search_youtube_for_urls.py``):

    python -m vince_tpu_torch.scrape.search_youtube_for_urls --output-dir data/r2v2_ids \\
        [--queries-file queries.txt] [--num-workers 64]

The queries are the lines of ``--queries-file``, or the WordNet table's
names (``info_files/full_imagenet_categories.txt``), or the 1000 ImageNet
class names. Each is searched on a pool of threads (Creative Commons videos
under 4 minutes); the ids are deduplicated, sorted and shuffled with
``random.Random(0)``; the first 65536 are ``val_ids.csv``, the rest
``train_ids.csv``.
"""

import argparse
import concurrent.futures
import csv
import os
import random

from vince_tpu_torch.utils import youtube_utils
from vince_tpu_torch.utils.util_functions import _load_class_names, load_imagenet_categories

VAL_SIZE = 65536


def main(argv=None):
    parser = argparse.ArgumentParser(description="Search YouTube for category videos")
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--num-workers", type=int, default=64)
    parser.add_argument("--results-per-query", type=int, default=50)
    parser.add_argument("--queries-file", default=None,
                        help="one search query per line (default: the full WordNet "
                             "category table)")
    args = parser.parse_args(argv)

    if args.queries_file:
        with open(args.queries_file) as f:
            queries = [line.strip() for line in f if line.strip()]
    else:
        queries = [name for _, name in load_imagenet_categories()]
        if not queries:
            queries = _load_class_names("imagenet_classes.txt") or []
    if not queries:
        raise SystemExit("no queries (provide --queries-file or info_files/*)")

    ids = set()
    with concurrent.futures.ThreadPoolExecutor(args.num_workers) as pool:
        for result in pool.map(
                lambda q: youtube_utils.search_youtube(q, args.results_per_query), queries):
            ids.update(result)
    ids = sorted(ids)
    random.Random(0).shuffle(ids)
    val, train = ids[:VAL_SIZE], ids[VAL_SIZE:]
    os.makedirs(args.output_dir, exist_ok=True)
    for name, rows in (("train", train), ("val", val)):
        with open(os.path.join(args.output_dir, f"{name}_ids.csv"), "w", newline="") as f:
            csv.writer(f).writerows([[v] for v in rows])
    print(f"wrote {len(train)} train / {len(val)} val ids")
    return train, val


if __name__ == "__main__":
    main()
