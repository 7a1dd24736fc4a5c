"""Instruction counts of the sigma kernels' inner loops, from their SASS.

    python3 -m artist_tpu_torch.tools.sass_counts [SOURCE.cu | LIBRARY.so ...]

With no argument it compiles ``artist_tpu_torch/kernels/csrc/blocking.cu``;
given two sources (say, a parent commit's ``blocking.cu`` and this one), it
also says which kernels compile to the same instructions in both.
A ``.cu`` file is compiled with the build's own flags (``kernels/build.py``)
into a library under ``artist_tpu_torch/_build/``; ``cuobjdump -sass`` then
disassembles the library. For every kernel it prints ``ptxas``'s registers
and spills and, where the kernel has a loop over (ray, primitive) pairs, that
loop's instructions per pair, by class: fp32 (FFMA, FADD, FMUL), MUFU (EX2,
RCP), shared loads and stores, shuffles, selects, and the rest. A pair loop
is the innermost backward branch whose body holds ``EXPONENTIALS_PER_PAIR``
MUFU.EX2 or a multiple of it (the pair math takes five exponentials), and
its pairs per iteration are its EX2 count over five: a loop unrolled over
several rays or primitives counts each pair once. The counts are static:
every instruction in the body once, branches not weighted. A pair the kernel
leaves after its geometry (its gates overflow) skips the forward branches
over a pair's exponentials: ``skip_total`` counts the body without them.

From those counts :func:`floors_ms` gives a kernel's least time at a number
of pairs: the instructions over the card's issue rate, and the MUFU
operations over the MUFU pipe's rate. It needs ``nvcc`` and ``cuobjdump``
(``CUDA_HOME`` or ``/usr/local/cuda``), not a card.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

from artist_tpu_torch.kernels import build

EXPONENTIALS_PER_PAIR = 5
# H100 SXM at its 1.98 GHz boost clock, 132 SMs: four warp schedulers an SM
# each issue one warp instruction a clock (128 lanes: 33.5 T instructions/s),
# and the MUFU pipe gives 16 results a clock an SM (4.2 T/s).
INSTRUCTIONS_PER_S = 132 * 128 * 1.98e9
MUFU_PER_S = 132 * 16 * 1.98e9
CLASSES = {
    "fp32": ("FFMA", "FADD", "FMUL"),
    "mufu": ("MUFU",),
    "shared_loads": ("LDS",),
    "shared_stores": ("STS",),
    "shuffles": ("SHFL",),
    "selects": ("FSEL", "SEL"),
}

_INSTRUCTION = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s*(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_]+)*)([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_FUNCTION = re.compile(r"Function\s*:\s*(\S+)")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b")


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    return str(pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name)


def kernel_name(mangled: str) -> str:
    """``_ZN12_GLOBAL__N_126sigma_flat_backward_kernelILi4EEEv...`` -> ``sigma_flat_backward_kernel<4>``:
    the last of the length-prefixed names and its integer template arguments."""
    rest = mangled.removeprefix("_ZN") if mangled.startswith("_ZN") else mangled.removeprefix("_Z")
    name = None
    while (length := re.match(r"\d+", rest)) is not None:
        size = int(length.group())
        name, rest = rest[len(length.group()) : len(length.group()) + size], rest[len(length.group()) + size :]
    if name is None:
        return mangled
    arguments = re.match(r"I((?:L[a-z]\d+E)+)E", rest)
    return name + (f"<{', '.join(re.findall(r'L[a-z](\d+)E', arguments.group(1)))}>" if arguments else "")


def parse_sass(text: str) -> dict[str, list[tuple[int, str, int | None, str]]]:
    """``{kernel: [(address, opcode, branch target or None, instruction text), ...]}`` from
    ``cuobjdump -sass``."""
    functions: dict[str, list] = {}
    current = None
    labels: dict[str, int] = {}
    pending_labels: list[str] = []
    raw: list[tuple[int, str, str]] = []

    def close():
        if current is not None:
            functions[current] = [
                (address, opcode, _branch_target(operands, labels), f"{opcode}{operands}".strip())
                for address, opcode, operands in raw
            ]

    for line in text.splitlines():
        function = _FUNCTION.search(line)
        if function:
            close()
            current, labels, pending_labels, raw = kernel_name(function.group(1)), {}, [], []
            continue
        label = _LABEL.match(line)
        if label:
            pending_labels.append(label.group(1))
            continue
        instruction = _INSTRUCTION.match(line)
        if instruction and current is not None:
            address = int(instruction.group(1), 16)
            for name in pending_labels:
                labels[name] = address
            pending_labels = []
            raw.append((address, instruction.group(2), instruction.group(3)))
    close()
    return functions


def _branch_target(operands: str, labels: dict[str, int]) -> int | None:
    found = _TARGET.search(operands)
    if not found:
        return None
    return labels.get(found.group(1)) if found.group(1) else int(found.group(2), 16)


def classify(opcode: str) -> str:
    base = opcode.split(".")[0]
    for name, bases in CLASSES.items():
        if base in bases:
            return name
    return "rest"


def pair_loop(instructions: list[tuple[int, str, int | None, str]]) -> dict | None:
    """The kernel's pair loop (see the module's note) and its counts per pair, or None."""
    loops = []
    for address, opcode, target, _ in instructions:
        if opcode.split(".")[0] == "BRA" and target is not None and target <= address:
            body = [op for a, op, _, _ in instructions if target <= a <= address]
            exponentials = sum(op == "MUFU.EX2" for op in body)
            if exponentials >= EXPONENTIALS_PER_PAIR:
                loops.append((target, address, body, exponentials))
    # Innermost: no other pair loop lies inside; of those, the one with the most pairs.
    innermost = [
        loop for loop in loops
        if not any(other is not loop and loop[0] <= other[0] and other[1] <= loop[1] for other in loops)
    ]
    if not innermost:
        return None
    start, end, body, exponentials = max(innermost, key=lambda loop: (loop[3], loop[1] - loop[0]))
    pairs = exponentials / EXPONENTIALS_PER_PAIR
    counts = {name: 0 for name in (*CLASSES, "rest")}
    opcodes: dict[str, int] = {}
    for opcode in body:
        counts[classify(opcode)] += 1
        opcodes[opcode] = opcodes.get(opcode, 0) + 1
    per_pair = {name: count / pairs for name, count in counts.items()}
    per_pair["total"] = len(body) / pairs
    per_pair["mufu_ex2"] = exponentials / pairs
    per_pair["mufu_rcp"] = opcodes.get("MUFU.RCP", 0) / pairs
    skipped = _skipped_addresses(instructions, start, end)
    per_pair["skip_total"] = (len(body) - len(skipped)) / pairs if skipped else None
    return dict(start=start, end=end, pairs_per_iteration=pairs, per_pair=per_pair, opcodes=opcodes)


def _skipped_addresses(instructions: list[tuple[int, str, int | None, str]], start: int, end: int) -> set[int]:
    """The addresses in the loop [start, end] that some forward branch of the loop
    jumps over together with a pair's exponentials."""
    skipped: set[int] = set()
    for address, opcode, target, _ in instructions:
        if not (start <= address < end and opcode.split(".")[0] == "BRA" and target is not None
                and address < target <= end):
            continue
        over = [(a, op) for a, op, _, _ in instructions if address < a < target]
        if sum(op == "MUFU.EX2" for _, op in over) >= EXPONENTIALS_PER_PAIR:
            skipped.update(a for a, _ in over)
    return skipped


def ptxas_report(output: str) -> dict[str, dict]:
    """``{kernel: {registers, spill_stores, spill_loads}}`` from ``-Xptxas -v`` output."""
    report: dict[str, dict] = {}
    current = None
    for line in output.splitlines():
        entry = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?: for|$)", line)
        if entry:
            current = kernel_name(entry.group(1))
            report.setdefault(current, {})
            continue
        if current is None:
            continue
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spills:
            report[current].update(spill_stores=int(spills.group(1)), spill_loads=int(spills.group(2)))
        registers = re.search(r"Used (\d+) registers", line)
        if registers:
            report[current]["registers"] = int(registers.group(1))
    return report


def library_for(path: pathlib.Path) -> tuple[pathlib.Path, str]:
    """A ``.so`` as it is, or a ``.cu`` compiled with the build's flags: the library and nvcc's output."""
    if path.suffix != ".cu":
        return path, ""
    digest = build._library_path(path).name.removeprefix(f"lib{path.stem}_")
    target = build.BUILD_DIR / f"sass_{path.stem}_{digest}"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", str(target), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {path}:\n{done.stdout}")
    return target, done.stdout


def disassemble(library: pathlib.Path) -> dict[str, list[tuple[int, str, int | None, str]]]:
    """:func:`parse_sass` of ``cuobjdump -sass library``."""
    return parse_sass(
        subprocess.run([_tool("cuobjdump"), "-sass", str(library)], capture_output=True, text=True, check=True).stdout
    )


def loop_counts(library: pathlib.Path) -> dict[str, dict | None]:
    """Each kernel of ``library``'s pair loop (:func:`pair_loop`), by kernel name."""
    return {name: pair_loop(instructions) for name, instructions in disassemble(library).items()}


def same_code(first: dict, second: dict) -> dict[str, bool]:
    """For each kernel in both :func:`disassemble` results, whether its instructions are
    the same, operands and branch targets included."""
    return {
        name: [i[3] for i in first[name]] == [i[3] for i in second[name]] for name in sorted(first.keys() & second.keys())
    }


def floors_ms(loop: dict, pairs: float, skipped_pairs: float = 0.0) -> dict[str, float]:
    """A kernel's least time at ``pairs`` pairs, ``skipped_pairs`` of them left after
    their geometry, from its pair loop's counts, in ms."""
    per_pair = loop["per_pair"]
    skip_total = per_pair["total"] if per_pair["skip_total"] is None else per_pair["skip_total"]
    full = pairs - skipped_pairs
    return dict(
        issue_ms=(per_pair["total"] * full + skip_total * skipped_pairs) / INSTRUCTIONS_PER_S * 1e3,
        mufu_ms=per_pair["mufu"] * full / MUFU_PER_S * 1e3,
    )


def main(paths: list[str]) -> int:
    """One JSON line a source: its kernels' registers and spills and their pair loops;
    given two or more, a last line saying which kernels compile to the same
    instructions in every source."""
    sources = [pathlib.Path(p) for p in paths] or [build.CSRC_DIR / "blocking.cu"]
    listings = []
    for path in sources:
        library, output = library_for(path)
        listings.append(disassemble(library))
        loops = {name: pair_loop(instructions) for name, instructions in listings[-1].items()}
        print(json.dumps(dict(source=str(path), ptxas=ptxas_report(output), loops=loops)))
    if len(listings) > 1:
        same = {name: all(same_code(listings[0], other).get(name, False) for other in listings[1:])
                for name in listings[0]}
        print(json.dumps({"same_code": same}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
