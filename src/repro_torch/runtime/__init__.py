"""The port's runtime layer: elastic re-planning on membership changes
(``ElasticController``).  Fault tolerance waits for the training slice
(``ROADMAP.md``)."""

from .elastic import ElasticController  # noqa: F401
