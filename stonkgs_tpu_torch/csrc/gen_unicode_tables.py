"""Generate Unicode tables for the C++ WordPiece tokenizer.

Emits ``unicode_tables.h`` with BMP (U+0000..U+FFFF) tables derived from
Python's unicodedata, so the C++ tokenizer matches the Python/HF reference
exactly on classification (control/whitespace/punctuation), lowercasing,
and NFD accent stripping:

  * ``kCharClass[cp]``  — bitmask: 1=whitespace, 2=control, 4=punctuation,
                          8=chinese char
  * ``kLowerStrip``     — cp -> lowercased + NFD-decomposed with Mn marks
                          removed (the BasicTokenizer do_lower_case path);
                          variable-length via an offset table.  Chars that
                          map to NOTHING (combining marks) are encoded with
                          the sentinel value 0x110000, distinguishing them
                          from identity mappings (empty offset range).
  * ``kAstralClass``    — sorted (start, end, mask) ranges covering
                          U+10000..U+10FFFF so supplementary-plane CJK,
                          format, and unassigned chars classify exactly like
                          Python's unicodedata (the BMP table covers the
                          rest).
"""

import sys
import unicodedata


def is_whitespace(ch):
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def is_control(ch):
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def is_punct(ch):
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def is_chinese(cp):
    return (
        (0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
        or (0xF900 <= cp <= 0xFAFF)
        # supplementary-plane CJK (HF _is_chinese_char)
        or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
        or (0x2F800 <= cp <= 0x2FA1F)
    )


# For the Final_Sigma lowercasing context (Unicode SpecialCasing):
# cased ~ Lu/Ll/Lt; case-ignorable ~ Mn/Me/Cf/Lm/Sk + MidLetter/MidNumLet
_CASE_IGNORABLE_EXTRA = {0x27, 0x2E, 0x3A, 0xB7, 0x2018, 0x2019, 0x2027,
                         0x05F4, 0xFE13, 0xFE52, 0xFE55, 0xFF07, 0xFF0E,
                         0xFF1A, 0x00AD, 0x0387}


def is_cased(ch):
    return unicodedata.category(ch) in ("Lu", "Ll", "Lt")


def is_case_ignorable(ch):
    if ord(ch) in _CASE_IGNORABLE_EXTRA:
        return True
    return unicodedata.category(ch) in ("Mn", "Me", "Cf", "Lm", "Sk")


def lower_strip(ch):
    """text.lower() then NFD + remove Mn (BasicTokenizer order)."""
    low = ch.lower()
    return [c for c in unicodedata.normalize("NFD", low)
            if unicodedata.category(c) != "Mn"]


# a char whose mapping is EMPTY (stripped combining marks) is encoded as
# this out-of-range sentinel — an empty offset range means identity
STRIP_SENTINEL = 0x110000


def emit_map(name, fn, out):
    """Variable-length cp -> cp-sequence map as (offsets, data) arrays."""
    offsets = [0]
    data = []
    for cp in range(0x10000):
        ch = chr(cp)
        seq = fn(ch)
        mapped = [ord(c) for c in seq]
        if mapped == [cp]:
            mapped = []  # identity: encode as empty (lookup falls through)
        elif not mapped:
            mapped = [STRIP_SENTINEL]  # maps to nothing (e.g. U+0301)
        data.extend(mapped)
        offsets.append(len(data))
    out.write(f"static const uint32_t {name}Offsets[65537] = {{\n")
    out.write(",".join(str(v) for v in offsets))
    out.write("};\n")
    out.write(f"static const uint32_t {name}Data[{max(len(data), 1)}] = {{\n")
    out.write(",".join(str(v) for v in data) or "0")
    out.write("};\n")


def emit_astral_ranges(out):
    """Sorted (start, end_inclusive, mask) ranges for U+10000..U+10FFFF."""
    ranges = []
    cur_mask, cur_start = None, None
    for cp in range(0x10000, 0x110000):
        ch = chr(cp)
        m = 0
        if is_whitespace(ch):
            m |= 1
        if is_control(ch):
            m |= 2
        if is_punct(ch):
            m |= 4
        if is_chinese(cp):
            m |= 8
        if is_cased(ch):
            m |= 16
        if is_case_ignorable(ch):
            m |= 32
        if m != cur_mask:
            if cur_mask:
                ranges.append((cur_start, cp - 1, cur_mask))
            cur_mask, cur_start = m, cp
    if cur_mask:
        ranges.append((cur_start, 0x10FFFF, cur_mask))
    out.write("struct AstralRange { uint32_t start, end; uint8_t mask; };\n")
    out.write(f"static const AstralRange kAstralClass[{len(ranges)}] = {{\n")
    out.write(",".join(f"{{{a},{b},{m}}}" for a, b, m in ranges))
    out.write("};\n")
    out.write(f"static const int kAstralClassCount = {len(ranges)};\n")


def main(path="unicode_tables.h"):
    with open(path, "w") as out:
        out.write("// Auto-generated by gen_unicode_tables.py — do not edit.\n")
        out.write("#pragma once\n#include <cstdint>\n")
        klass = []
        for cp in range(0x10000):
            ch = chr(cp)
            m = 0
            if is_whitespace(ch):
                m |= 1
            if is_control(ch):
                m |= 2
            if is_punct(ch):
                m |= 4
            if is_chinese(cp):
                m |= 8
            if is_cased(ch):
                m |= 16
            if is_case_ignorable(ch):
                m |= 32
            klass.append(m)
        out.write("static const uint8_t kCharClass[65536] = {\n")
        out.write(",".join(str(v) for v in klass))
        out.write("};\n")
        emit_map("kLowerStrip", lower_strip, out)
        emit_astral_ranges(out)
    print(f"wrote {path}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "unicode_tables.h")
