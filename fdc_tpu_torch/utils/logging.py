# Copied from fdc_tpu/utils/logging.py; only the import paths differ.
"""Structured logging with the reference's 3-way verbose modes.

Every reference component replicates a NOLOG / LOGTOCONSOLE / LOGTOFILE enum
with fixed per-component log files
(reference: lib/SegmentDetection_impl.cc:659-672,
python/FrequencyDomainChannelizer.py:359-371); here one factory serves all
components.
"""

from __future__ import annotations

import sys

from fdc_tpu_torch.config import VerboseMode

__all__ = ["make_logger"]


def make_logger(verbose: VerboseMode, logfile: str):
    """Returns log(s) -> None for the given mode.

    LOGTOFILE truncates the file on first use and appends after, matching the
    reference behavior (reference: lib/SegmentDetection_impl.cc:49-57).
    Write failures are reported to stderr and never raised.
    """
    verbose = VerboseMode(verbose)
    if verbose == VerboseMode.NOLOG:
        return lambda s: None
    if verbose == VerboseMode.LOGTOCONSOLE:
        return lambda s: print(str(s))

    state = {"initialized": False}

    def log(s):
        try:
            mode = "a" if state["initialized"] else "w"
            with open(logfile, mode) as fh:
                if not state["initialized"]:
                    fh.write("\n")
                    state["initialized"] = True
                fh.write(str(s) + "\n")
        except OSError:
            print(f"Logfile not writable: {logfile}", file=sys.stderr)

    return log
