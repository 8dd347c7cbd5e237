"""The M71 data front (port of ``experiments/m71/make_fixture.py`` and
``prepare_data.py``): ``make_fixture`` writes the offline SDSS + Hubble
product set, ``prepare_data`` turns survey bytes into the tiles and fitted
hyperparameters the m71 suites read, and ``compare`` holds a regenerated
fixture to a committed one."""
