"""Sharding of the port's language models over a ``DATAxMODEL`` (or
``(pod, data, model)``) grid of rank processes: the reference's
logical-axis rules (:mod:`.sharding`), the collectives GSPMD inserts there
(:mod:`.collectives`), and the pod-axis int8 gradient compression
(:mod:`.compression`)."""
