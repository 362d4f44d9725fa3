"""Host reads of device values a request over the traced stretch: the calls
of the program's ``lsf.solve.flag_read``, ``lsf.solve.result_read`` and
``lsf.frame.report_read`` spans (a solve has no report read)."""

from portbench.lib import program

READS = ("lsf.solve.flag_read", "lsf.solve.result_read", "lsf.frame.report_read")


def read(r):
    return program.per_request(r, READS, "calls")
