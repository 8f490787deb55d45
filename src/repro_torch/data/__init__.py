"""DVBP instance sources (synthetic suites, Azure CSV loader)."""
from .traces import (DAY, HORIZON, azure_stream_meta,  # noqa: F401
                     iter_azure_requests, load_azure_csv,
                     make_azure_like_suite, make_huawei_like_suite)
