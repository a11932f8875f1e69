"""Trained-model downloader.

Equivalent of the reference DownloadModel (modules/python/DownloadModel.py:
8-27): fetch a CSV manifest listing released model checkpoints, then download
each into a local directory. Uses urllib instead of shelling out to wget and
supports file:// URLs (used by tests and air-gapped mirrors).
"""
from __future__ import annotations

import csv
import io
import os
import urllib.request
from typing import List, Optional

from helen_tpu_torch.obs import get_logger
from helen_tpu_torch.utils.filesystem import ensure_output_dir

log = get_logger("download")

#: default manifest: the reference's published model-description CSV
#: (reference DownloadModel.py:11); override with --manifest_url or
#: HELEN_TPU_MODEL_MANIFEST for mirrors
DEFAULT_MANIFEST_URL = (
    "https://storage.googleapis.com/kishwar-helen/models_helen/"
    "mp_helen_model_description.csv"
)


def download_models(
    output_dir: str,
    manifest_url: Optional[str] = None,
    timeout: float = 60.0,
) -> List[str]:
    """Download every model listed in the manifest CSV (columns: name, url).

    Returns the list of local paths written. Already-present files are kept.
    """
    manifest_url = (
        manifest_url
        or os.environ.get("HELEN_TPU_MODEL_MANIFEST")
        or DEFAULT_MANIFEST_URL
    )
    output_dir = ensure_output_dir(output_dir)
    log.info("fetching model manifest from %s", manifest_url)
    with urllib.request.urlopen(manifest_url, timeout=timeout) as resp:
        text = resp.read().decode("utf-8")

    paths = []
    for row in csv.reader(io.StringIO(text)):
        if not row or row[0].startswith("#"):
            continue
        if len(row) == 1:
            url = row[0].strip()
            name = os.path.basename(url)
        else:
            name, url = row[0].strip(), row[1].strip()
        if not os.path.splitext(name)[1]:
            # the reference saves wget's basename(url); manifest names are
            # bare model ids, so keep the real filename (extension included)
            name = os.path.basename(url) or name
        dest = os.path.join(output_dir, name)
        if os.path.exists(dest):
            log.info("already present: %s", name)
            paths.append(dest)
            continue
        log.info("downloading %s", name)
        # pid-suffixed so concurrent downloaders (e.g. several hosts sharing
        # a model dir) never write the same temp file
        tmp = f"{dest}.part{os.getpid()}"
        with urllib.request.urlopen(url, timeout=timeout) as resp, open(tmp, "wb") as f:
            while True:
                chunk = resp.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
        os.replace(tmp, dest)
        paths.append(dest)
    log.info("downloaded %d models to %s", len(paths), output_dir)
    return paths
