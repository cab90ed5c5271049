R"""Figure-PDF metadata stamping (provenance for publication figures); the
port's own copy of ``gsum_tpu/pdfmeta.py``, which imports no JAX.

The reference ships a docs-side helper that writes a Python dict into a
saved figure PDF's Info dictionary and reads it back, so published figures
carry their generation parameters (reference:
docs/notebooks/pdf_metadata.py:7-94, built on PyPDF2).  This module
provides the same capability with no third-party PDF dependency:

- :func:`save_figure_with_metadata` — matplotlib-native path for figures
  being saved anyway;
- :func:`add_pdf_metadata` — stamp custom keys into an EXISTING pdf via a
  standard PDF *incremental update* (appends a new Info object + xref
  section; the original bytes are untouched, so the update is lossless
  and reversible);
- :func:`get_pdf_metadata` — read the (latest) Info dictionary back as a
  plain dict.

Supports classic cross-reference-table PDFs (what matplotlib writes).
PDFs using compressed cross-reference streams are rejected with a clear
error rather than corrupted.
"""
import re

__all__ = ['add_pdf_metadata', 'get_pdf_metadata',
           'save_figure_with_metadata']

_STANDARD_KEYS = ('Producer', 'CreationDate', 'Creator', 'Author',
                  'Subject', 'Title', 'Keywords', 'ModDate', 'Trapped')


def save_figure_with_metadata(fig, path, metadata):
    """Save a matplotlib figure as PDF and stamp ``metadata`` into it.

    Standard Info keys (Title, Author, ...) go through matplotlib's own
    ``savefig(metadata=...)``; any custom keys are appended with
    :func:`add_pdf_metadata` afterwards.
    """
    std = {k: str(v) for k, v in metadata.items() if k in _STANDARD_KEYS}
    custom = {k: v for k, v in metadata.items() if k not in _STANDARD_KEYS}
    fig.savefig(path, metadata=std or None)
    if custom:
        add_pdf_metadata(path, custom)


def _validate_key(key):
    # the excluded class is the full spec delimiter set — including %
    # (comment start), # (the name-escape character, which compliant
    # readers would decode: 'a#20b' reads back as 'a b'), and {} —
    # not just the ones this module's own parser trips on
    if not re.fullmatch(r'[^\s/<>\[\](){}%#]+', key) or not key.isascii():
        raise ValueError('invalid PDF Info key %r: keys must be ASCII with '
                         'no whitespace or delimiter characters' % (key,))


def _pdf_string(value):
    """A PDF string object: literal when Latin-1 suffices, else a
    UTF-16BE hex string (the standard unicode encoding for Info values —
    and what :func:`_parse_info_dict` already decodes)."""
    out = str(value)
    try:
        out.encode('latin-1')
    except UnicodeEncodeError:
        raw = b'\xfe\xff' + out.encode('utf-16-be')
        return '<' + raw.hex().upper() + '>'
    return '(' + _escape_literal(out) + ')'


def _escape_literal(value):
    out = str(value)
    for ch, esc in (('\\', r'\\'), ('(', r'\('), (')', r'\)'),
                    ('\n', r'\n'), ('\r', r'\r'), ('\t', r'\t')):
        out = out.replace(ch, esc)
    return out


def _unescape_literal(raw):
    subs = {'n': '\n', 'r': '\r', 't': '\t', 'b': '\b', 'f': '\f',
            '(': '(', ')': ')', '\\': '\\'}
    out, i = [], 0
    while i < len(raw):
        c = raw[i]
        if c == '\\' and i + 1 < len(raw):
            nxt = raw[i + 1]
            if nxt in subs:
                out.append(subs[nxt])
                i += 2
                continue
            if nxt.isdigit():  # octal escape, up to 3 digits
                j = i + 1
                while j < len(raw) and j < i + 4 and raw[j].isdigit():
                    j += 1
                out.append(chr(int(raw[i + 1:j], 8)))
                i = j
                continue
        out.append(c)
        i += 1
    return ''.join(out)


def _last_trailer(data):
    """The last classic trailer dict and the last startxref offset."""
    idx = data.rfind(b'trailer')
    if idx < 0:
        if b'/XRef' in data:
            raise ValueError(
                'PDF uses a compressed cross-reference stream (no classic '
                'trailer); cannot update it in place — re-save the figure '
                'with save_figure_with_metadata instead')
        raise ValueError('no PDF trailer found')
    m = re.search(rb'<<(.*?)>>\s*startxref\s+(\d+)', data[idx:], re.S)
    if m is None:
        raise ValueError('malformed PDF trailer')
    return m.group(1), int(m.group(2))


def _find_object(data, num):
    """Body of object ``num 0 obj ... endobj`` (last occurrence wins:
    incremental updates append redefinitions)."""
    matches = list(re.finditer((r'(?<![0-9])%d\s+0\s+obj' % num).encode(),
                               data))
    if not matches:
        raise ValueError('object %d not found' % num)
    start = matches[-1].end()
    end = data.find(b'endobj', start)
    if end < 0:
        raise ValueError('object %d not terminated' % num)
    return data[start:end]


def _scan_literal(text, i):
    """End index (past ')') of the literal string starting at text[i]=='('.
    Handles escapes and the BALANCED unescaped parens the spec allows."""
    depth, j = 0, i
    n = len(text)
    while j < n:
        c = text[j:j + 1]
        if c == b'\\':
            j += 2
            continue
        if c == b'(':
            depth += 1
        elif c == b')':
            depth -= 1
            if depth == 0:
                return j + 1
        j += 1
    raise ValueError('unterminated PDF literal string')


def _scan_value(text, i):
    """``(end, kind)`` of the PDF value starting at text[i]; kind is
    'str' for string objects (decodable) and 'raw' for everything an
    Info dict may legally hold besides strings — names (/Trapped /False),
    indirect references (12 0 R), numbers, booleans, arrays — which the
    rewrite must carry through VERBATIM rather than drop or re-type."""
    c = text[i:i + 1]
    if c == b'(':
        return _scan_literal(text, i), 'str'
    if text[i:i + 2] == b'<<':  # nested dict (rare in Info): balanced scan
        depth, j = 0, i
        while j < len(text):
            if text[j:j + 2] == b'<<':
                depth += 1
                j += 2
            elif text[j:j + 2] == b'>>':
                depth -= 1
                j += 2
                if depth == 0:
                    return j, 'raw'
            elif text[j:j + 1] == b'(':
                j = _scan_literal(text, j)
            else:
                j += 1
        raise ValueError('unterminated PDF dictionary')
    if c == b'<':
        j = text.index(b'>', i)
        return j + 1, 'str'
    if c == b'[':
        depth, j = 0, i
        while j < len(text):
            cj = text[j:j + 1]
            if cj == b'(':
                j = _scan_literal(text, j)
                continue
            if cj == b'[':
                depth += 1
            elif cj == b']':
                depth -= 1
                if depth == 0:
                    return j + 1, 'raw'
            j += 1
        raise ValueError('unterminated PDF array')
    if c == b'/':  # name value
        m = re.match(rb'/[^\s/<>\[\](){}%]*', text[i:])
        return i + m.end(), 'raw'
    # number, boolean, null — possibly the head of an indirect ref "n g R"
    m = re.match(rb'\d+\s+\d+\s+R\b', text[i:])
    if m:
        return i + m.end(), 'raw'
    m = re.match(rb'[^\s/<>\[\](){}%]+', text[i:])
    if m is None:
        raise ValueError('unparseable PDF value at offset %d' % i)
    return i + m.end(), 'raw'


def _decode_pdf_string(val):
    if val.startswith(b'('):
        return _unescape_literal(val[1:-1].decode('latin-1'))
    hexstr = re.sub(rb'\s', b'', val[1:-1]).decode('ascii')
    if len(hexstr) % 2:
        hexstr += '0'
    raw = bytes.fromhex(hexstr)
    if raw[:2] == b'\xfe\xff':
        return raw[2:].decode('utf-16-be')
    return raw.decode('latin-1')


def _parse_info_entries(body):
    """Ordered ``[(key, kind, value)]`` of an Info dict: kind 'str' with
    the decoded python string, or 'raw' with the verbatim bytes token."""
    entries = []
    i = 0
    while True:
        m = re.search(rb'/([^\s/<>\[\](){}%]+)', body[i:])
        if m is None:
            break
        key = m.group(1).decode('latin-1')
        j = i + m.end()
        while body[j:j + 1] in (b' ', b'\n', b'\r', b'\t'):
            j += 1
        if body[j:j + 1] in (b'', b'>'):
            break
        end, kind = _scan_value(body, j)
        val = (_decode_pdf_string(body[j:end]) if kind == 'str'
               else body[j:end])
        entries.append((key, kind, val))
        i = end
    return entries


def _parse_info_dict(body):
    """``{key: str}`` of an Info dict; non-string values (names, refs,
    numbers) are reported as their raw latin-1 token text."""
    out = {}
    for key, kind, val in _parse_info_entries(body):
        out[key] = val if kind == 'str' else val.decode('latin-1')
    return out


def _trailer_entries(trailer):
    size = re.search(rb'/Size\s+(\d+)', trailer)
    root = re.search(rb'/Root\s+(\d+)\s+(\d+)\s+R', trailer)
    info = re.search(rb'/Info\s+(\d+)\s+(\d+)\s+R', trailer)
    ident = re.search(rb'/ID\s*(\[.*?\])', trailer, re.S)
    if size is None or root is None:
        raise ValueError('PDF trailer is missing /Size or /Root')
    return (int(size.group(1)), root.group(0),
            int(info.group(1)) if info else None,
            ident.group(1) if ident else None)


def get_pdf_metadata(pdf_file, exclude=True):
    """Read the PDF's Info dictionary as a plain dict.

    With ``exclude=True`` (default) the standard Adobe keys are dropped so
    only the custom provenance entries remain — matching the reference
    helper's behavior (reference docs/notebooks/pdf_metadata.py:61-94).
    """
    with open(pdf_file, 'rb') as fh:
        data = fh.read()
    trailer, _ = _last_trailer(data)
    _, _, info_num, _ = _trailer_entries(trailer)
    if info_num is None:
        return {}
    meta = _parse_info_dict(_find_object(data, info_num))
    if exclude:
        for key in _STANDARD_KEYS:
            meta.pop(key, None)
    return meta


def add_pdf_metadata(pdf_file, metadata_dict):
    """Add ``metadata_dict`` to the PDF's Info dictionary in place.

    Existing entries are preserved (new keys win on collision).  The
    update is appended as a PDF incremental update: a replacement Info
    object, a one-entry cross-reference section, and a new trailer whose
    ``/Prev`` points at the original — viewers and parsers that follow
    the spec see the merged metadata; the original bytes stay intact.

    Same contract as the reference helper: keys must contain no
    whitespace, values are strings (reference
    docs/notebooks/pdf_metadata.py:7-58).
    """
    if not isinstance(metadata_dict, dict):
        raise TypeError('metadata_dict must be a dict')
    for key in metadata_dict:
        _validate_key(str(key))

    with open(pdf_file, 'rb') as fh:
        data = fh.read()
    trailer, prev_xref = _last_trailer(data)
    size, root_entry, info_num, ident = _trailer_entries(trailer)

    # key -> ('str', python str) | ('raw', verbatim bytes).  Raw entries
    # (name values like /Trapped /False, indirect references, numbers)
    # are carried through unchanged — re-typing them as strings would
    # corrupt the Info dict for spec-compliant readers.
    merged = {}
    if info_num is not None:
        for k, kind, v in _parse_info_entries(_find_object(data, info_num)):
            merged[k] = (kind, v)
    merged.update({str(k): ('str', str(v))
                   for k, v in metadata_dict.items()})

    new_num = size  # first unused object number
    entries = ''.join(
        '/%s %s ' % (k, _pdf_string(v) if kind == 'str'
                     else v.decode('latin-1'))
        for k, (kind, v) in merged.items())
    obj = ('%d 0 obj\n<< %s>>\nendobj\n' % (new_num, entries)).encode('latin-1')

    base = data if data.endswith(b'\n') else data + b'\n'
    obj_offset = len(base)
    xref_offset = obj_offset + len(obj)
    xref = ('xref\n0 1\n0000000000 65535 f \n%d 1\n%010d 00000 n \n'
            % (new_num, obj_offset)).encode('ascii')
    trailer_parts = [b'/Size ' + str(new_num + 1).encode(),
                     root_entry,
                     b'/Info %d 0 R' % new_num,
                     b'/Prev ' + str(prev_xref).encode()]
    if ident:
        trailer_parts.append(b'/ID ' + ident)
    new_trailer = (b'trailer\n<< ' + b' '.join(trailer_parts) + b' >>\n'
                   + b'startxref\n' + str(xref_offset).encode()
                   + b'\n%%EOF\n')

    with open(pdf_file, 'wb') as fh:
        fh.write(base + obj + xref + new_trailer)
