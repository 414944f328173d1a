"""Interactive viewing: orbit camera, SIBR-compatible network viewer
(counterpart of `d3gs_tpu/viewer/`)."""
from .network_viewer import NetworkViewer  # noqa: F401
from .orbit import OrbitCamera  # noqa: F401
