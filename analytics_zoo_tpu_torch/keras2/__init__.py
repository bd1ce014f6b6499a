"""The Keras-2 namespace (``analytics_zoo_tpu/keras2``): the port's ``nn``
under the reference's ``keras2`` import paths::

    from analytics_zoo_tpu_torch.keras2.layers import Dense, Conv2D
    from analytics_zoo_tpu_torch.keras2.models import Model, Sequential
"""

from . import layers, models  # noqa: F401
