"""The dry run's analysis, the reference package's ``analysis/``: the
three-term roofline (``roofline``), the policy A/B report
(``perf_report``) and the experiments document (``experiments_doc``),
read from ``launch/dryrun.py``'s records under ``results/torch/``."""
