"""NNImageReader: image directory -> DataFrame with a decoded image column
(port of ``analytics_zoo_tpu/nnframes/nn_image_reader.py``, over the
port's ``data.image``).

Reference: ``pyzoo/zoo/pipeline/nnframes/nn_image_reader.py``:
``NNImageReader.readImages(path, sc)`` produced a Spark DataFrame with an
``image`` struct column (origin/height/width/nChannels/mode/data) consumed
by NNEstimator via ImageFeatureToTensor preprocessing.

Here: a pandas frame whose ``image`` column holds decoded HWC float32
ndarrays (the struct fields live as plain columns), reusing the
data.image decode + transform chain.  Feeds NNEstimator directly:
``setFeaturesCol("image")``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np


class NNImageReader:
    @staticmethod
    def readImages(path: str, transforms: Optional[Sequence[Callable]] = None,
                   with_label: bool = True):
        """Read a directory (class-per-subdir when ``with_label``) into a
        pandas DataFrame with columns: image (HWC ndarray), origin (path),
        height, width, n_channels, and label when present."""
        import pandas as pd

        from ..data.image import ImageSet, apply_chain, decode_image

        iset = ImageSet.read(path, with_label=with_label)
        rows = []
        for i, p in enumerate(iset.paths):
            img = apply_chain(decode_image(p), list(transforms or []))
            if img.dtype.kind in "ui":
                # decode yields uint8; models need float activations (a
                # uint8 feed would truncate every conv/dense output)
                img = img.astype(np.float32)
            row = {"image": img, "origin": p, "height": img.shape[0],
                   "width": img.shape[1],
                   "n_channels": img.shape[2] if img.ndim == 3 else 1}
            if iset.labels is not None:
                row["label"] = int(iset.labels[i])
            rows.append(row)
        return pd.DataFrame(rows)
