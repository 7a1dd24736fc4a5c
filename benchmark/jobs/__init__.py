"""One module a job kind, named by a configuration's ``job``: how the port runs it, and how the reference follows it.

A job module offers ``make_traffic`` (the traffic from a workload file's parameters
and the seed), ``build`` (the port's entry, set up, with the optimizer readings the
check compares), ``reference_inputs``, ``reference_steps``, ``LAUNCH_COUNTERS`` (the
port's modules whose ``LAUNCHES`` a traced call reads) and ``kernel_work`` (what the
traced calls needed of each kernel family, counted on the reference's rays, as the
roofline metrics read it).
"""
