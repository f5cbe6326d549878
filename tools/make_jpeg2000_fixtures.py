"""Make the JPEG 2000 texture fixtures of tests/goldens/jpeg2000/.

    cd tools && JAX_PLATFORMS=cpu python make_jpeg2000_fixtures.py

Writes, from seed 5678, five maps laid out as helmet.scn's (B and E sRGB,
N, R, M), each a JPEG 2000 kind that tracy_tpu reads through PIL's
OpenJPEG and the port decodes without it (csrc/image_jpeg2000.cpp):

- basecolor.jp2: 256x256 RGB JP2, the 9/7 wavelet and ICT, 3 quality
  layers, 128-px tiles;
- normal.j2k: 256x256 RGB raw codestream, the 5/3 wavelet and RCT, RPCL,
  64-px precincts;
- roughness.jp2: 256x256 grey JP2;
- metalness.j2k: 128x128 grey raw codestream of signed samples, PCRL;
- emissive.jp2: 128x128 RGBA JP2, CPRL, with PLT markers;

then jpeg2000.scn, which uses them on a sphere and a box over an
untextured floor, and jpeg2000.npz: tracy_tpu's render of that scene on
the CPU (tools/make_texture_fixtures.py's settings: accel 'bvh', rng
'fast', 256x192, 24 frames of 1 spp). Besides, big.jp2: a 2048x2048 RGB
JP2 (9/7, 3 layers, 5 resolution levels, under 400 KB) of a smooth
pattern, which chip_smoke.py decodes and times on the card's host.

And small files of what PIL's writer cannot make, each decoded by PIL
(tracy_tpu's loader) and held against the port by
tests/test_torch_image_jpeg2000.py: written by Pillow's bundled OpenJPEG
(libopenjp2 2.5.4) through ctypes, `encode` below (code-block styles,
SOP/EPH, POC, ROI, subsampling, tile-parts, TLM, 4- and 12-bit samples,
five components), or rewritten from such a
codestream (`with_ppt`, `with_ppm`: packet headers moved into PPT or PPM
markers; `tile_headers`: COD, QCD, COC, QCC, POC and RGN in the tile-part
header; `merged`: components of different coding styles joined under COC
and QCC; `interleaved`: the tile-parts of several tiles taken in turn;
PLM and CRG markers added). Needs PIL and jax.
"""

from __future__ import annotations

import ctypes as C
import glob
import io
import os
import struct
import sys
import tempfile

import numpy as np
import PIL
from PIL import Image

from make_format_fixtures import rect_pattern, render_golden
from make_texture_fixtures import REPO, u8

OUT = os.path.join(REPO, "tests", "goldens", "jpeg2000")
SEED = 5678
SIZES = [(256, 256), (256, 256), (256, 256), (128, 128), (128, 128)]  # rows, columns

SCN = """# JPEG 2000 fixture: helmet.scn's five map slots (B and E sRGB, N, R, M)
# as JP2 files and raw codestreams, made by tools/make_jpeg2000_fixtures.py.
SCN JPEG 2000 fixture
OUT 256 192
CAM (0, 1.0, 3.2) (0.0, 0.55, 0.0) (0.0, 1.0, 0.0) 45.0
MTL Textured (1.0, 1.0, 1.0) 1 0
MTL Floor (0.4, 0.4, 0.4) 1 0
TEX Textured B basecolor.jp2 SRGB
TEX Textured N normal.j2k
TEX Textured R roughness.jp2
TEX Textured M metalness.j2k
TEX Textured E emissive.jp2 SRGB
SKY (0.7, 0.8, 1.0)
OBJ S (-0.45, 0.6, 0) 0.6 Textured
OBJ B (0.35, 0.0, -0.4) (1.15, 0.8, 0.4) Textured
OBJ B (-20.0, -0.2, -20.0) (20.0, 0, 20.0) Floor
"""

# ---------------------------------------------------------------- OpenJPEG

_PATH, _RLVLS, _SPECS = 4096, 33, 16
_u32, _i32, _int = C.c_uint32, C.c_int32, C.c_int


class _Poc(C.Structure):  # opj_poc_t
    _fields_ = ([(n, _u32) for n in ("resno0", "compno0", "layno1", "resno1", "compno1",
                                     "layno0", "precno0", "precno1")]
                + [("prg1", _int), ("prg", _int), ("progorder", C.c_char * 5), ("tile", _u32)]
                + [(n, _i32) for n in ("tx0", "tx1", "ty0", "ty1")]
                + [(n, _u32) for n in ("layS", "resS", "compS", "prcS", "layE", "resE", "compE",
                                       "prcE", "txS", "txE", "tyS", "tyE", "dx", "dy", "lay_t",
                                       "res_t", "comp_t", "prc_t", "tx0_t", "ty0_t")])


class _CParams(C.Structure):  # opj_cparameters_t
    _fields_ = ([(n, _int) for n in ("tile_size_on", "cp_tx0", "cp_ty0", "cp_tdx", "cp_tdy",
                                     "cp_disto_alloc", "cp_fixed_alloc", "cp_fixed_quality")]
                + [("cp_matrice", C.c_void_p), ("cp_comment", C.c_char_p), ("csty", _int),
                   ("prog_order", _int), ("POC", _Poc * 32), ("numpocs", _u32),
                   ("tcp_numlayers", _int), ("tcp_rates", C.c_float * 100),
                   ("tcp_distoratio", C.c_float * 100)]
                + [(n, _int) for n in ("numresolution", "cblockw_init", "cblockh_init", "mode",
                                       "irreversible", "roi_compno", "roi_shift", "res_spec")]
                + [("prcw_init", _int * _RLVLS), ("prch_init", _int * _RLVLS),
                   ("infile", C.c_char * _PATH), ("outfile", C.c_char * _PATH),
                   ("index_on", _int), ("index", C.c_char * _PATH)]
                + [(n, _int) for n in ("image_offset_x0", "image_offset_y0", "subsampling_dx",
                                       "subsampling_dy", "decod_format", "cod_format",
                                       "jpwl_epc_on", "jpwl_hprot_MH")]
                + [(n, _int * _SPECS) for n in ("jpwl_hprot_TPH_tileno", "jpwl_hprot_TPH",
                                                "jpwl_pprot_tileno", "jpwl_pprot_packno",
                                                "jpwl_pprot")]
                + [(n, _int) for n in ("jpwl_sens_size", "jpwl_sens_addr", "jpwl_sens_range",
                                       "jpwl_sens_MH")]
                + [(n, _int * _SPECS) for n in ("jpwl_sens_TPH_tileno", "jpwl_sens_TPH")]
                + [("cp_cinema", _int), ("max_comp_size", _int), ("cp_rsiz", _int),
                   ("tp_on", C.c_char), ("tp_flag", C.c_char), ("tcp_mct", C.c_char),
                   ("jpip_on", _int), ("mct_data", C.c_void_p), ("max_cs_size", _int),
                   ("rsiz", C.c_uint16)])


class _CmptParm(C.Structure):  # opj_image_cmptparm_t
    _fields_ = [(n, _u32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd")]


class _ImageComp(C.Structure):  # opj_image_comp_t
    _fields_ = ([(n, _u32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd",
                                     "resno_decoded", "factor")]
                + [("data", C.POINTER(_i32)), ("alpha", C.c_uint16)])


class _Image(C.Structure):  # opj_image_t
    _fields_ = ([(n, _u32) for n in ("x0", "y0", "x1", "y1", "numcomps")]
                + [("color_space", _int), ("comps", C.POINTER(_ImageComp)),
                   ("icc_profile_buf", C.c_void_p), ("icc_profile_len", _u32)])


_lib = None


def openjpeg():
    """Pillow's bundled libopenjp2 2.5.4, its functions typed."""
    global _lib
    if _lib is None:
        found = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs",
                                       "libopenjp2-*.so.2.5.4"))
        if not found:
            raise RuntimeError("Pillow's bundled libopenjp2 2.5.4 is not installed")
        lib = C.CDLL(found[0])
        vp = C.c_void_p
        lib.opj_image_create.restype = C.POINTER(_Image)
        lib.opj_create_compress.restype = vp
        lib.opj_stream_create_default_file_stream.restype = vp
        for name, args in (("opj_setup_encoder", [vp, vp, vp]), ("opj_start_compress", [vp, vp, vp]),
                           ("opj_encode", [vp, vp]), ("opj_end_compress", [vp, vp]),
                           ("opj_encoder_set_extra_options", [vp, C.POINTER(C.c_char_p)])):
            getattr(lib, name).restype = _int
            getattr(lib, name).argtypes = args
        for name in ("opj_stream_destroy", "opj_destroy_codec", "opj_image_destroy"):
            getattr(lib, name).argtypes = [vp]
        _lib = lib
    return _lib


def _defaults():
    """opj_set_default_encoder_parameters into a buffer with room to spare,
    the layout checked against the defaults it sets."""
    buf = (C.c_uint8 * (C.sizeof(_CParams) + 65536))()
    openjpeg().opj_set_default_encoder_parameters(buf)
    p = _CParams.from_buffer(buf)
    got = (p.numresolution, p.cblockw_init, p.cblockh_init, p.roi_compno, p.subsampling_dx,
           p.subsampling_dy, p.decod_format, p.cod_format)
    if got != (6, 64, 64, -1, 1, 1, -1, -1):
        raise RuntimeError(f"opj_cparameters_t does not match this layout: {got}")
    return buf, p


PROGRESSIONS = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}


def encode(planes, *, dx=None, dy=None, prec=8, sgnd=False, offset=(0, 0), jp2=False,
           irreversible=False, mct=None, numres=None, cblk=(64, 64), mode=0, csty=0,
           prog="LRCP", pocs=(), rates=(), roi=None, tiles=None, tile_offset=(0, 0),
           tp_flag=None, precincts=(), extra=()) -> bytes:
    """A codestream (or JP2 file) of `planes`, one integer array a component
    at its own resolution, written by OpenJPEG with these parameters: `mode`
    the code-block style bits (1 bypass, 2 reset, 4 termall, 8 vertically
    causal, 16 predictable termination, 32 segmentation symbols), `csty` 2
    SOP and 4 EPH, `pocs` (res0, comp0, lay1, res1, comp1, order) entries,
    `roi` (component, shift), `tp_flag` 'R', 'L' or 'C' tile-parts,
    `rates` the layers' compression ratios (lossless without), `extra`
    OpenJPEG's options ("TLM=YES", "PLT=YES")."""
    lib = openjpeg()
    n = len(planes)
    dx, dy = dx or [1] * n, dy or [1] * n
    cp = (_CmptParm * n)()
    for k, a in enumerate(planes):
        cp[k].dx, cp[k].dy = dx[k], dy[k]
        cp[k].h, cp[k].w = a.shape
        cp[k].x0, cp[k].y0 = offset
        cp[k].prec = cp[k].bpp = prec
        cp[k].sgnd = int(sgnd)
    img = lib.opj_image_create(n, cp, 2 if n <= 2 else 1)  # grey, sRGB
    im = img.contents
    h0, w0 = planes[0].shape
    im.x0, im.y0 = offset
    im.x1, im.y1 = offset[0] + (w0 - 1) * dx[0] + 1, offset[1] + (h0 - 1) * dy[0] + 1
    for k, a in enumerate(planes):
        flat = np.ascontiguousarray(a, np.int32).ravel()
        C.memmove(im.comps[k].data, flat.ctypes.data, flat.nbytes)
    buf, p = _defaults()
    p.irreversible = int(irreversible)
    p.tcp_mct = bytes([int(n >= 3 if mct is None else mct)])
    p.numresolution = numres or p.numresolution
    p.cblockw_init, p.cblockh_init = cblk
    p.mode, p.csty, p.prog_order = mode, csty, PROGRESSIONS[prog]
    p.cp_disto_alloc = 1
    p.tcp_numlayers = max(1, len(rates))
    for k, r in enumerate(rates or (0,)):
        p.tcp_rates[k] = r
    for k, (res0, comp0, lay1, res1, comp1, order) in enumerate(pocs):
        q = p.POC[k]
        q.tile, q.resno0, q.compno0, q.layno1, q.resno1, q.compno1 = 1, res0, comp0, lay1, res1, comp1
        q.prg1 = PROGRESSIONS[order]
    p.numpocs = len(pocs)
    if roi:
        p.roi_compno, p.roi_shift = roi
    if tiles:
        p.tile_size_on = 1
        (p.cp_tdx, p.cp_tdy), (p.cp_tx0, p.cp_ty0) = tiles, tile_offset
    p.image_offset_x0, p.image_offset_y0 = offset
    if tp_flag:
        p.tp_on, p.tp_flag = b"\x01", tp_flag.encode()
    if precincts:
        p.csty |= 1
        p.res_spec = len(precincts)
        for k, (pw, ph) in enumerate(precincts):
            p.prcw_init[k], p.prch_init[k] = pw, ph
    codec = lib.opj_create_compress(2 if jp2 else 0)
    fd, path = tempfile.mkstemp(suffix=".jp2" if jp2 else ".j2k")
    os.close(fd)
    try:
        if not lib.opj_setup_encoder(codec, buf, img):
            raise RuntimeError("opj_setup_encoder refused the parameters")
        if extra:
            opts = (C.c_char_p * (len(extra) + 1))(*[e.encode() for e in extra], None)
            if not lib.opj_encoder_set_extra_options(codec, opts):
                raise RuntimeError(f"OpenJPEG refused the options {extra}")
        stream = lib.opj_stream_create_default_file_stream(path.encode(), 0)
        ok = (lib.opj_start_compress(codec, img, stream) and lib.opj_encode(codec, stream)
              and lib.opj_end_compress(codec, stream))
        lib.opj_stream_destroy(stream)
        if not ok:
            raise RuntimeError("OpenJPEG failed to encode")
        with open(path, "rb") as f:
            return f.read()
    finally:
        os.unlink(path)
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(img)


# ---------------------------------------------------------------- surgery

def segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def split(cs: bytes):
    """(main header segments, tile-parts, EOC-terminated?) of a codestream:
    each segment (marker, body); each tile-part (Isot, TPsot, TNsot,
    header segments, data)."""
    assert cs[:2] == b"\xff\x4f"
    at, main = 2, []
    while True:
        (m,) = struct.unpack(">H", cs[at:at + 2])
        if m == 0xFF90:
            break
        (n,) = struct.unpack(">H", cs[at + 2:at + 4])
        main.append((m, cs[at + 4:at + 2 + n]))
        at += 2 + n
    parts = []
    while struct.unpack(">H", cs[at:at + 2])[0] == 0xFF90:
        isot, psot, tpsot, tnsot = struct.unpack(">HIBB", cs[at + 4:at + 12])
        end = at + psot
        hat, hdr = at + 12, []
        while struct.unpack(">H", cs[hat:hat + 2])[0] != 0xFF93:
            m, n = struct.unpack(">HH", cs[hat:hat + 4])
            hdr.append((m, cs[hat + 4:hat + 2 + n]))
            hat += 2 + n
        parts.append([isot, tpsot, tnsot, hdr, cs[hat + 2:end]])
        at = end
    assert cs[at:] == b"\xff\xd9"
    return main, parts


def join(main, parts) -> bytes:
    out = b"\xff\x4f" + b"".join(segment(m, b) for m, b in main)
    for isot, tpsot, tnsot, hdr, data in parts:
        head = b"".join(segment(m, b) for m, b in hdr)
        psot = 12 + len(head) + 2 + len(data)
        out += struct.pack(">HHHIBB", 0xFF90, 10, isot, psot, tpsot, tnsot) + head + b"\xff\x93" + data
    return out + b"\xff\xd9"


def packets(data: bytes):
    """(header with its EPH, SOP + body) of each packet of a tile-part
    written with SOP and EPH markers: a header never holds 0xFF92 (bit
    stuffing) and a body never holds 0xFF91 (the MQ coder's rule)."""
    out, at = [], 0
    while at < len(data):
        assert data[at:at + 2] == b"\xff\x91"
        eph = data.index(b"\xff\x92", at + 6) + 2
        nxt = data.find(b"\xff\x91", eph)
        nxt = len(data) if nxt < 0 else nxt
        out.append((data[at + 6:eph], data[at:at + 6] + data[eph:nxt]))
        at = nxt
    return out


def chunks(b: bytes, size: int):
    return [b[i:i + size] for i in range(0, len(b), size)] or [b""]


def with_ppt(cs: bytes, chunk=64, restart=False) -> bytes:
    """The packet headers of each tile-part (SOP and EPH written) moved into
    its PPT markers, `chunk` bytes each, numbered on across a tile's
    tile-parts (from 0 in each tile-part with `restart`, which OpenJPEG
    refuses)."""
    main, parts = split(cs)
    zppt = {}
    for part in parts:
        pk = packets(part[4])
        heads = b"".join(h for h, _ in pk)
        if restart:
            zppt[part[0]] = 0
        for c in chunks(heads, chunk):
            z = zppt.get(part[0], 0)
            part[3] = part[3] + [(0xFF61, bytes([z]) + c)]
            zppt[part[0]] = z + 1
        part[4] = b"".join(b for _, b in pk)
    return join(main, parts)


def interleaved(cs: bytes) -> bytes:
    """The tile-parts of a codestream reordered round-robin over its tiles
    (each tile's in their order)."""
    main, parts = split(cs)
    by_tile = {}
    for part in parts:
        by_tile.setdefault(part[0], []).append(part)
    order = []
    while any(by_tile.values()):
        order += [by_tile[t].pop(0) for t in sorted(by_tile) if by_tile[t]]
    return join(main, order)


def with_ppm(cs: bytes, chunk=50, split_nppm=False) -> bytes:
    """The packet headers of every tile-part moved into the main header's
    PPM markers (Nppm, then the headers, per tile-part), cut every `chunk`
    bytes; a cut inside an Nppm field moves to its start. With `split_nppm`
    one more cut falls inside the second tile-part's Nppm (OpenJPEG then
    refuses the file)."""
    main, parts = split(cs)
    stream, fields = b"", []
    for part in parts:
        pk = packets(part[4])
        heads = b"".join(h for h, _ in pk)
        fields.append(len(stream))
        stream += struct.pack(">I", len(heads)) + heads
        part[4] = b"".join(b for _, b in pk)
    cuts = set()
    for at in range(chunk, len(stream), chunk):
        inside = [f for f in fields if f < at < f + 4]
        cuts.add(inside[0] if inside else at)
    if split_nppm:
        cuts.add(fields[1] + 2)
    cuts = [0] + sorted(cuts) + [len(stream)]
    pieces = [stream[a:b] for a, b in zip(cuts, cuts[1:])]
    main = main + [(0xFF60, bytes([z]) + c) for z, c in enumerate(pieces)]
    return join(main, parts)


def tile_headers(cs: bytes, moved=(0xFF5F, 0xFF5E), decoy_cblk=None) -> bytes:
    """The markers in `moved` carried from the main header into the first
    tile-part header of every tile. With `decoy_cblk`, the main COD's
    code-block exponents are replaced by it and the real COD and QCD go to
    the tile-part headers too (which a decoder must take over the main
    header's)."""
    main, parts = split(cs)
    carry = [(m, b) for m, b in main if m in moved or (decoy_cblk and m in (0xFF52, 0xFF5C))]
    keep = [(m, b) for m, b in main if m not in moved]
    if decoy_cblk:
        keep = [(m, b[:6] + bytes(decoy_cblk) + b[8:] if m == 0xFF52 else b) for m, b in keep]
        keep = [(m, bytes([b[0] & 0x1F | 0x20]) + b[1:] if m == 0xFF5C else b) for m, b in keep]
    for part in parts:
        if part[1] == 0:
            part[3] = carry + part[3]
    return join(keep, parts)


def merged(streams) -> bytes:
    """Single-component CPRL codestreams of one size and layer count joined
    into one of len(streams) components: the first's COD and QCD, the
    others' as COC and QCC, the tile bodies one after the other (CPRL gives
    each component's packets in turn)."""
    split_all = [split(s) for s in streams]
    main0, parts0 = split_all[0]
    siz = dict(main0)[0xFF51]
    siz = siz[:34] + struct.pack(">H", len(streams)) + siz[36:39] * len(streams)
    main = [(0xFF51, siz)] + [(m, b) for m, b in main0 if m not in (0xFF51,)]
    for k, (mk, _) in enumerate(split_all[1:], start=1):
        d = dict(mk)
        cod, qcd = d[0xFF52], d[0xFF5C]
        main.append((0xFF53, bytes([k, cod[0] & 1]) + cod[5:]))
        main.append((0xFF5D, bytes([k]) + qcd))
    body = b"".join(p[0][4] for _, p in split_all)
    assert all(len(p) == 1 for _, p in split_all)
    return join(main, [[0, 0, 1, parts0[0][3], body]])


# ---------------------------------------------------------------- files

def pil(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="JPEG2000", **kw)
    return buf.getvalue()


def put(name: str, data: bytes):
    with open(os.path.join(OUT, name), "wb") as f:
        f.write(data)


def kinds(rng):
    """The small files of what PIL's writer cannot make, by name."""
    rgb = u8(rect_pattern(40, 48, rng, 3)).astype(np.int32)
    rgba = u8(rect_pattern(36, 44, rng, 4)).astype(np.int32)
    noise = rng.integers(-12, 13, rgb.shape)
    rgb = np.clip(rgb + noise, 0, 255)
    planes = [rgb[..., k] for k in range(3)]
    out = {}
    for name, mode in (("bypass", 1), ("reset", 2), ("termall", 4), ("causal", 8),
                       ("pterm", 16), ("segsym", 32), ("all", 63)):
        out[f"style_{name}.j2k"] = encode(planes, mode=mode, rates=[30, 8, 1], numres=4)
        out[f"style_{name}_97.j2k"] = encode(planes, mode=mode, rates=[30, 8], numres=4,
                                             irreversible=True, cblk=(16, 16))
    sop = encode(planes, csty=6, rates=[20, 4, 1], tiles=(32, 24), numres=3,
                 precincts=[(16, 16)] * 3)
    out["sop_eph.j2k"] = sop
    out["ppt.j2k"] = with_ppt(sop)
    out["ppm.j2k"] = with_ppm(sop)
    out["ppm_split_nppm.j2k"] = with_ppm(sop, split_nppm=True)  # refused by both
    poc = encode(planes, rates=[20, 4, 1], numres=4, precincts=[(16, 16)] * 4,
                 pocs=[(0, 0, 2, 2, 3, "RPCL"), (0, 0, 3, 4, 3, "CPRL")])
    out["poc.j2k"] = poc
    out["poc_tile.j2k"] = tile_headers(poc)
    at = poc.index(b"\xff\x5f") + 4 + 5  # the first entry's CEpoc
    out["poc_cepoc0.j2k"] = poc[:at] + b"\0" + poc[at + 1:]
    out["roi.j2k"] = encode(planes, roi=(0, 4), rates=[25, 6])
    roi = encode([p.astype(np.int32) for p in planes], roi=(1, 7), irreversible=True)
    out["roi_97.j2k"] = roi
    out["roi_tile.j2k"] = tile_headers(roi)
    out["cod_tile.j2k"] = tile_headers(encode(planes, cblk=(16, 16), numres=3, tiles=(24, 20)),
                                       moved=(), decoy_cblk=(4, 4))
    half = rgb[::2, ::2]
    out["sub420.j2k"] = encode([rgb[..., 0], half[..., 1], half[..., 2]], dx=[1, 2, 2],
                               dy=[1, 2, 2], mct=0, rates=[12, 3])
    out["sub422.jp2"] = encode([rgb[..., 0], rgb[:, ::2, 1], rgb[:, ::2, 2]], dx=[1, 2, 2],
                               dy=[1, 1, 1], mct=0, jp2=True)
    odd = rgb[:-1, :-3]  # no tile of the grid below is one sample wide
    out["sub420_tiles.j2k"] = encode([odd[..., 0], odd[::2, ::2, 1], odd[::2, ::2, 2]],
                                     dx=[1, 2, 2], dy=[1, 2, 2], mct=0, numres=3, tiles=(16, 16),
                                     offset=(4, 6), tile_offset=(1, 2), irreversible=True)
    rgba_planes = [rgba[..., k] for k in range(4)]
    out["tileparts_r.j2k"] = encode(rgba_planes, tiles=(16, 16), numres=3, tp_flag="R",
                                    rates=[20, 5], prog="RLCP")
    out["tileparts_c.j2k"] = encode(rgba_planes, tiles=(24, 24), numres=3, tp_flag="C",
                                    rates=[20, 5], prog="CPRL", irreversible=True)
    out["tlm_plt.j2k"] = encode(planes, tiles=(16, 16), numres=3, extra=("TLM=YES", "PLT=YES"))
    parts = encode(planes, csty=6, tiles=(24, 24), numres=3, tp_flag="R", rates=[20, 5],
                   prog="RLCP")
    out["tileparts_interleaved.j2k"] = interleaved(parts)
    out["ppm_tileparts.j2k"] = with_ppm(parts, 40)
    out["ppt_tileparts.j2k"] = with_ppt(parts, 40)
    out["ppt_repeated_index.j2k"] = with_ppt(parts, 40, restart=True)  # refused by both
    main, tps = split(encode(planes, numres=3))
    crg = (0xFF63, struct.pack(">HH", 0, 0) * 3)
    out["plm_crg.j2k"] = join(main + [(0xFF57, bytes([0, 2, 0x81, 0x05])), crg], tps)
    deep = (rgb.astype(np.int32) << 4) | rng.integers(0, 16, rgb.shape)
    out["grey12.j2k"] = encode([deep[..., 0]], prec=12, rates=[10, 1])
    out["rgb12.j2k"] = encode([deep[..., k] for k in range(3)], prec=12, irreversible=True)
    out["rgb12_signed.j2k"] = encode([deep[..., k] - 2048 for k in range(3)], prec=12, sgnd=True)
    out["rgb4.j2k"] = encode([rgb[..., k] >> 4 for k in range(3)], prec=4)
    out["five.j2k"] = encode(planes + planes[:2], mct=0)  # refused by both
    out["coc_qcc.j2k"] = coc = merged([
        encode([planes[0]], numres=5, prog="CPRL"),
        encode([planes[1]], numres=3, prog="CPRL", irreversible=True, cblk=(16, 32),
               precincts=[(32, 32), (16, 16), (8, 8)]),
        encode([planes[2]], numres=2, prog="CPRL", cblk=(32, 8), mode=1 | 8)])
    out["coc_qcc_tile.j2k"] = tile_headers(coc, moved=(0xFF53, 0xFF5D))
    return out


def write_maps(rng):
    os.makedirs(OUT, exist_ok=True)
    (bh, bw), (nh, nw), (rh, rw), (mh, mw), (eh, ew) = SIZES
    base = Image.fromarray(u8(rect_pattern(bh, bw, rng, 3)))
    put("basecolor.jp2", pil(base, irreversible=True, quality_layers=[40, 15, 6],
                             tile_size=(128, 128)))
    bump = rect_pattern(nh, nw, rng, 2) - 0.5
    nrm = np.concatenate([0.5 + 0.3 * bump, np.ones_like(bump[..., :1])], axis=-1)
    put("normal.j2k", pil(Image.fromarray(u8(nrm)), no_jp2=True, progression="RPCL",
                          precinct_size=(64, 64), num_resolutions=4))
    put("roughness.jp2", pil(Image.fromarray(u8(rect_pattern(rh, rw, rng, 1))[..., 0])))
    put("metalness.j2k", pil(Image.fromarray(u8(rect_pattern(mh, mw, rng, 1))[..., 0]),
                             no_jp2=True, signed=True, progression="PCRL",
                             precinct_size=(32, 32), num_resolutions=3))
    glow = rect_pattern(eh, ew, rng, 4)
    glow[..., :3] = np.where(glow[..., :3] > 0.6, glow[..., :3], 0.0)
    put("emissive.jp2", pil(Image.fromarray(u8(glow)), progression="CPRL", plt=True))
    with open(os.path.join(OUT, "jpeg2000.scn"), "w") as f:
        f.write(SCN)


def write_big(rng):
    """2048x2048 9/7 RGB JP2, 3 layers, 5 resolution levels."""
    y, x = np.mgrid[0:2048, 0:2048].astype(np.float32) / 2048
    chans = []
    for _ in range(3):
        a, b, c = rng.uniform(2, 9, 3)
        chans.append(0.5 + 0.3 * np.sin(a * x + c) * np.cos(b * y) + 0.15 * np.sin((a + b) * (x + y)))
    img = Image.fromarray(u8(np.clip(np.stack(chans, -1), 0, 1)))
    put("big.jp2", pil(img, irreversible=True, quality_layers=[400, 160, 40], num_resolutions=5))


def main():
    rng = np.random.default_rng(SEED)
    write_maps(rng)
    write_big(rng)
    for name, data in kinds(rng).items():
        put(name, data)
    render_golden(OUT, "jpeg2000", SIZES)
    sizes = {n: os.path.getsize(os.path.join(OUT, n)) for n in sorted(os.listdir(OUT))}
    print(sizes, sum(sizes.values()), "bytes")


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
