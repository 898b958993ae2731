"""The port's refusals by design.

:class:`Refusal` is what the port raises for a configuration it does not
run, as the reference refuses it (an encoder-decoder under FSDP's block
resolver, paged serving of a windowed arch, a sequence-sharded
encoder-decoder cache, ...).  It is a ``NotImplementedError``, so callers
that catch that go on working; the dry-run records a cell that raises it as
refused, and any other exception, a ``NotImplementedError`` of torch's
included, as an error.
"""


class Refusal(NotImplementedError):
    """A configuration the port does not run, by design."""
