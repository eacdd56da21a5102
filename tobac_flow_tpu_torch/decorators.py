"""Metadata decorators (counterpart of ``tobac_flow_tpu/decorators.py``).

``configure_dataarray`` wraps a detection function so that when one of
its array arguments after the first (the flow) is a :class:`DataArray`,
the result comes back as a DataArray with that argument's coordinates and
dimensions, a configured name and attributes, and the stale attributes
dropped.  A tensor result stays a tensor inside the DataArray, where it
lies, until ``.values`` is read.
"""

from __future__ import annotations

import functools

from tobac_flow_tpu_torch.data.ncdataset import DataArray

__all__ = ["configure_dataarray"]


def configure_dataarray(name=None, drop_attrs=(), **attrs):
    def decorator(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            # call-time overrides, as the reference's scripts pass them
            out_name = kwargs.pop("name", name)
            extra_attrs = kwargs.pop("attributes", None) or {}
            template = next((a for a in args[1:] if isinstance(a, DataArray)), None)
            result = func(*args, **kwargs)
            if isinstance(result, DataArray):
                result.name = out_name
                result.attrs.update(extra_attrs)
                return result
            if template is None:
                return result
            out_attrs = {k: v for k, v in template.attrs.items() if k not in set(drop_attrs)}
            out_attrs.update({k: v for k, v in attrs.items() if v is not None})
            out_attrs.update(extra_attrs)
            return DataArray(result, coords=dict(template.coords), dims=template.dims,
                             name=out_name, attrs=out_attrs)

        return wrapper

    return decorator
