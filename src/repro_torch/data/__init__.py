"""DVBP instance sources (synthetic suites, Azure CSV loader)."""
from .traces import (DAY, HORIZON, load_azure_csv,  # noqa: F401
                     make_azure_like_suite, make_huawei_like_suite)
