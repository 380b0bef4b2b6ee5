"""The native library loader (``native``) and the serving scheduler
(``sched``)."""
