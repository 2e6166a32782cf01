"""Download the packaged R2V2 tar shards (counterpart of
``vince_tpu/scrape/download_r2v2.py``):

    python -m vince_tpu_torch.scrape.download_r2v2 \\
        --urls-file vince_tpu_torch/info_files/r2v2_drive_urls.txt --output-path data/r2v2

Lines are ``<shard tag> <url>`` or a bare URL. Each shard is fetched
(``drive.fetch_url``: Drive URLs through the confirm flow), extracted with
``filter="data"`` (nothing lands outside the output) and removed; a shard
that fails in any way is reported and passed over.
"""

import argparse
import os
import tarfile

from vince_tpu_torch.scrape.drive import fetch_url


def main(argv=None):
    parser = argparse.ArgumentParser(description="Download pre-packaged R2V2 shards")
    parser.add_argument("--urls-file", required=True)
    parser.add_argument("--output-path", required=True)
    args = parser.parse_args(argv)

    shards = []
    with open(args.urls_file) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if len(parts) == 2:
                shards.append((parts[0], parts[1]))
            else:
                shards.append((f"{len(shards):04d}", parts[0]))
    os.makedirs(args.output_path, exist_ok=True)
    failed = []
    for i, (tag, url) in enumerate(shards):
        tar_path = os.path.join(args.output_path, f"shard_{tag}.tar")
        try:
            print(f"[{i + 1}/{len(shards)}] {tag}: {url}")
            fetch_url(url, tar_path)
            with tarfile.open(tar_path) as tf:
                tf.extractall(args.output_path, filter="data")
        except Exception as e:
            # any failure of one shard: a bad line (ValueError), a truncated
            # body, an HTML page (ReadError), the network (OSError)
            print(f"shard {tag} failed ({type(e).__name__}: {e}); continuing")
            failed.append(tag)
            continue
        finally:
            try:
                if os.path.exists(tar_path):
                    os.remove(tar_path)
            except OSError:
                pass
    if failed:
        print(f"{len(failed)}/{len(shards)} shards failed: {failed[:10]}"
              + ("..." if len(failed) > 10 else ""))
    return failed


if __name__ == "__main__":
    main()
