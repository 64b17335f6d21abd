"""Exception types (port of ``metrics_tpu/utils/exceptions.py``)."""


class MetricsTPUUserError(Exception):
    """Error raised for misuse of the metrics API."""


# Alias with a generic name used across the package.
UserError = MetricsTPUUserError
