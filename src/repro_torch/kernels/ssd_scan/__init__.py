from .ops import ssd_scan
from .ref import ssd_scan_ref, ssd_scan_tf32_ref
