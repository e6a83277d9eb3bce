"""Command-line tools over the port's own outputs: the dry-run's reports
and op records (``top_ops``, ``roofline_md``) and the serving obs files
(``check_obs``)."""
