"""Settings for every pytest session rooted at the repository.

Hypothesis draws one fixed sample: every ``@given`` test draws the same
examples, derived from the test itself, in every run, and no example saved
under ``.hypothesis/`` by an earlier run is replayed. So one tree gives one
pass/fail set. ``--hypothesis-profile=default`` on the command line draws at
random again and keeps the example database.
"""
try:
    from hypothesis import settings
except ImportError:  # pragma: no cover - collection must not need hypothesis
    pass
else:
    settings.register_profile("fixed", derandomize=True, database=None)
    settings.load_profile("fixed")
