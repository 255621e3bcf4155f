"""The decode stage's time per gather: the mean of every ``decode`` span
(``serving/inferer.py``, the host's entropy decode and IDCT of a gather's
JPEGs, ``native/jpeg.py``) that ended in the window, in milliseconds."""


def read(run):
    spans = run.spans_in("decode")
    return 1e3 * sum(spans) / len(spans) if spans else None
