"""Pulsar-archive cleaning hook (host-side, optional external deps).

Capability-parity stub for the reference's psrchive + coast_guard
cleaning step (scint_utils.py:27-64). Both dependencies are external
C++/Python tools that are not part of this framework; the hook keeps
the same call surface and degrades with a clear error when they are
absent, so survey pipelines can gate on :func:`archive_tools_available`.
"""

from __future__ import annotations


def archive_tools_available():
    """True when psrchive's python bindings and coast_guard import."""
    try:
        import psrchive  # noqa: F401
        from coast_guard import cleaners  # noqa: F401
    except Exception:
        return False
    return True


def make_dynspec(archive, template=None, phasebin=1):
    """Create a psrflux-format dynamic spectrum from a pulsar archive
    by invoking the external ``psrflux`` tool
    (``psrflux -s template -e dynspec archive``) — the reference's
    stub documents the command without running it
    (scint_utils.py:894-899); here it is executed when psrflux is on
    PATH and raises with the exact command otherwise."""
    import shutil
    import subprocess

    if phasebin != 1:
        # psrflux has no phase-binning option; the reference's stub
        # carries the parameter but never uses it either
        raise ValueError("phasebin != 1 is not supported by psrflux")
    cmd = ["psrflux"]
    if template is not None:
        cmd += ["-s", str(template)]
    cmd += ["-e", "dynspec", str(archive)]
    if shutil.which("psrflux") is None:
        raise RuntimeError(
            "psrflux (psrchive) is not installed; run manually: "
            + " ".join(cmd))
    subprocess.run(cmd, check=True)
    return f"{archive}.dynspec"


def clean_archive(archive, template=None, bandwagon=0.99, channel_threshold=5,
                  subint_threshold=5, output_directory=None):
    """Clean RFI from a psrchive archive with coast_guard's surgical and
    bandwagon cleaners, then unload the cleaned archive
    (scint_utils.py:27-64 behaviour).

    Raises ImportError with installation guidance when the external
    tools are missing.
    """
    try:
        import psrchive
        from coast_guard import cleaners
    except ImportError as e:
        raise ImportError(
            "clean_archive requires the external 'psrchive' python "
            "bindings and 'coast_guard' (neither ships with "
            "scintools_tpu_torch); install them or pre-clean archives before "
            "loading") from e

    if isinstance(archive, str):
        archive = psrchive.Archive_load(archive)

    cleaner = cleaners.load_cleaner("surgical")
    surgical_parameters = (
        f"chan_numpieces=1,subint_numpieces=1,"
        f"chanthresh={channel_threshold},subintthresh={subint_threshold}")
    if template is not None:
        surgical_parameters += f",template={template}"
    cleaner.parse_config_string(surgical_parameters)
    cleaner.run(archive)

    if bandwagon:
        cleaner = cleaners.load_cleaner("bandwagon")
        cleaner.parse_config_string(
            f"badchantol={bandwagon},badsubtol=1.0")
        cleaner.run(archive)

    unload_name = archive.get_filename().split("/")[-1]
    if output_directory is not None:
        unload_name = f"{output_directory.rstrip('/')}/{unload_name}"
    archive.unload(unload_name)
    return archive
