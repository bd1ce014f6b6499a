"""Friesian of the port (copies of ``analytics_zoo_tpu/friesian/``).

Friesian: recommender-system feature engineering (reference SURVEY.md
§2.2 — pyzoo/zoo/friesian/feature/table.py on Spark DataFrames).

``FeatureTable`` is the offline (sharded pandas) half;
``FeaturePipeline`` replays the fitted transforms per request in the
serving path (plain dicts, picklable, no pandas).
"""

from .table import FeatureTable, StringIndex
from .pipeline import FeaturePipeline

__all__ = ["FeatureTable", "StringIndex", "FeaturePipeline"]
