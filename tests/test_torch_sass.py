"""The SASS loop count (raytrace_tpu_torch/utils/sass.py) on hand-written
`cuobjdump -sass` text: the innermost loop with the most marker
instructions, its length and its instructions per test. Building and
disassembling a kernel needs the CUDA toolkit; the parsing does not."""
import pytest

from raytrace_tpu_torch.utils import sass


def _listing(labels: bool) -> str:
    """Two functions. `_Z4testv` holds an outer loop around two inner
    loops: A (12 FMUL in 17 instructions) and B (6 FMUL in 8). Branch
    targets are addresses (cuobjdump) or labels (nvdisasm)."""
    body = [("MOV R1, R2", None),
            ("FMUL R3, R1, R2", "outer"),
            ("FADD R4, R3, R2", "a")]
    body += [("FMUL R5, R4, R3", None)] * 12
    body += [("FMNMX R6, R5, R4, PT", None)] * 3
    body += [("@!P1 BRA a", None),
             ("ISETP.GE.AND P2, PT, R1, 0x4, PT", "b")]
    body += [("FMUL R7, R6, R5", None)] * 6
    body += [("@P2 BRA b", None), ("@!UP0 BRA outer", None),
             ("EXIT", None)]
    addr = {}
    for i, (_, label) in enumerate(body):
        if label:
            addr[label] = i * 16
    lines = ["\tcode for sm_90a", "\t\tFunction : other_kernel",
             "        /*0000*/                   FMUL R1, R2, R3 ;",
             "        /*0010*/                   FMUL R1, R2, R3 ;",
             "        /*0020*/               @P0 BRA 0x0 ;",
             "\t\tFunction : _Z4testv"]
    number = {"outer": 1, "a": 2, "b": 3}
    for i, (ins, label) in enumerate(body):
        if label and labels:
            lines.append(f".L_x_{number[label]}:")
        if " BRA " in ins:
            head, name = ins.rsplit(" ", 1)
            target = f"`(.L_x_{number[name]})" if labels else hex(addr[name])
            ins = f"{head} {target}"
        lines.append(f"        /*{i * 16:04x}*/                   {ins} ;"
                     "   /* 0x000fe20000000f00 */")
    return "\n".join(lines)


@pytest.mark.parametrize("labels", [False, True])
def test_loop_report_takes_the_innermost_loop_with_most_markers(labels):
    got = sass.loop_report(_listing(labels), "_Z4testv", "FMUL", 6)
    assert got == dict(function="_Z4testv", marker="FMUL",
                       loop_instructions=17, tests_per_iteration=2.0,
                       instructions_per_test=8.5)


def test_loop_report_raises_without_a_marked_loop():
    with pytest.raises(RuntimeError, match="no loop holds MUFU.RCP"):
        sass.loop_report(_listing(False), "_Z4testv", "MUFU.RCP", 1)
    with pytest.raises(RuntimeError, match="no SASS for missing_kernel"):
        sass.loop_report(_listing(False), "missing_kernel", "FMUL", 6)
