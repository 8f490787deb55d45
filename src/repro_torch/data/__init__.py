"""Data sources: DVBP instances (synthetic suites, Azure CSV loader), the
token pipeline and sequence packing of the training path."""
from .packing import pack_documents  # noqa: F401
from .tokens import PrefetchLoader, TokenStream  # noqa: F401
from .traces import (DAY, HORIZON, azure_stream_meta,  # noqa: F401
                     iter_azure_requests, load_azure_csv,
                     make_azure_like_suite, make_huawei_like_suite)
