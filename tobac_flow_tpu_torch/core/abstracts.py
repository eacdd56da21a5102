"""Abstract contract for semi-Lagrangian flow containers (counterpart of
``tobac_flow_tpu/core/abstracts.py``): a Flow holds forward and backward
flow vectors of shape (t, y, x, 2) and exposes the semi-Lagrangian
operations."""

from __future__ import annotations

import abc


class AbstractFlow(abc.ABC):
    """Contract for flow-field containers exposing semi-Lagrangian ops."""

    @property
    @abc.abstractmethod
    def flow(self):
        """Return (forward_flow, backward_flow)."""

    @abc.abstractmethod
    def __getitem__(self, items):
        """Return a sliced view of the flow object."""

    @abc.abstractmethod
    def convolve(self, data, **kwargs):
        """Flow-warped convolution of data."""

    @abc.abstractmethod
    def diff(self, data, **kwargs):
        """Semi-Lagrangian central difference along the leading dimension."""

    @abc.abstractmethod
    def sobel(self, data, **kwargs):
        """Semi-Lagrangian Sobel edge magnitude."""

    @abc.abstractmethod
    def watershed(self, field, markers, **kwargs):
        """Flow-aware watershed segmentation."""

    @abc.abstractmethod
    def label(self, data, **kwargs):
        """Flow-aware connected-component labelling."""

    @abc.abstractmethod
    def link_overlap(self, data, **kwargs):
        """Link existing labels into contiguous objects via warped overlap."""
