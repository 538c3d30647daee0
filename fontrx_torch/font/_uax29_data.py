"""UAX#29 Grapheme_Cluster_Break classes and Extended_Pictographic ranges.

A checked copy of ``fontrx/font/_uax29_data.py``, which
``tools/gen_uax29_data.py`` generated from the system ICU (Unicode 15.0).
The tables are the segmentation function of ``fontrx_torch.font.uax29``, so
they are copied whole. The port imports nothing of the JAX package, not even
this module, which imports no JAX; ``tests/test_torch_edit.py`` holds each
table equal to the original, so this is a checked copy and not a fork.

- ``CLASSES``: the class names, indexed by ``GCB_IDS``;
- ``GCB_STARTS`` / ``GCB_IDS``: the first code point of each range and its
  class (a range runs to the next start);
- ``EXTPICT``: the sorted, inclusive ``(lo, hi)`` Extended_Pictographic
  ranges.
"""

CLASSES = ('CN', 'CR', 'EX', 'L', 'LF', 'LV', 'LVT', 'PP', 'RI', 'SM', 'T', 'V', 'XX', 'ZWJ')

GCB_STARTS = (
    0x0000,
    0x000A,
    0x000B,
    0x000D,
    0x000E,
    0x0020,
    0x007F,
    0x00A0,
    0x00AD,
    0x00AE,
    0x0300,
    0x0370,
    0x0483,
    0x048A,
    0x0591,
    0x05BE,
    0x05BF,
    0x05C0,
    0x05C1,
    0x05C3,
    0x05C4,
    0x05C6,
    0x05C7,
    0x05C8,
    0x0600,
    0x0606,
    0x0610,
    0x061B,
    0x061C,
    0x061D,
    0x064B,
    0x0660,
    0x0670,
    0x0671,
    0x06D6,
    0x06DD,
    0x06DE,
    0x06DF,
    0x06E5,
    0x06E7,
    0x06E9,
    0x06EA,
    0x06EE,
    0x070F,
    0x0710,
    0x0711,
    0x0712,
    0x0730,
    0x074B,
    0x07A6,
    0x07B1,
    0x07EB,
    0x07F4,
    0x07FD,
    0x07FE,
    0x0816,
    0x081A,
    0x081B,
    0x0824,
    0x0825,
    0x0828,
    0x0829,
    0x082E,
    0x0859,
    0x085C,
    0x0890,
    0x0892,
    0x0898,
    0x08A0,
    0x08CA,
    0x08E2,
    0x08E3,
    0x0903,
    0x0904,
    0x093A,
    0x093B,
    0x093C,
    0x093D,
    0x093E,
    0x0941,
    0x0949,
    0x094D,
    0x094E,
    0x0950,
    0x0951,
    0x0958,
    0x0962,
    0x0964,
    0x0981,
    0x0982,
    0x0984,
    0x09BC,
    0x09BD,
    0x09BE,
    0x09BF,
    0x09C1,
    0x09C5,
    0x09C7,
    0x09C9,
    0x09CB,
    0x09CD,
    0x09CE,
    0x09D7,
    0x09D8,
    0x09E2,
    0x09E4,
    0x09FE,
    0x09FF,
    0x0A01,
    0x0A03,
    0x0A04,
    0x0A3C,
    0x0A3D,
    0x0A3E,
    0x0A41,
    0x0A43,
    0x0A47,
    0x0A49,
    0x0A4B,
    0x0A4E,
    0x0A51,
    0x0A52,
    0x0A70,
    0x0A72,
    0x0A75,
    0x0A76,
    0x0A81,
    0x0A83,
    0x0A84,
    0x0ABC,
    0x0ABD,
    0x0ABE,
    0x0AC1,
    0x0AC6,
    0x0AC7,
    0x0AC9,
    0x0ACA,
    0x0ACB,
    0x0ACD,
    0x0ACE,
    0x0AE2,
    0x0AE4,
    0x0AFA,
    0x0B00,
    0x0B01,
    0x0B02,
    0x0B04,
    0x0B3C,
    0x0B3D,
    0x0B3E,
    0x0B40,
    0x0B41,
    0x0B45,
    0x0B47,
    0x0B49,
    0x0B4B,
    0x0B4D,
    0x0B4E,
    0x0B55,
    0x0B58,
    0x0B62,
    0x0B64,
    0x0B82,
    0x0B83,
    0x0BBE,
    0x0BBF,
    0x0BC0,
    0x0BC1,
    0x0BC3,
    0x0BC6,
    0x0BC9,
    0x0BCA,
    0x0BCD,
    0x0BCE,
    0x0BD7,
    0x0BD8,
    0x0C00,
    0x0C01,
    0x0C04,
    0x0C05,
    0x0C3C,
    0x0C3D,
    0x0C3E,
    0x0C41,
    0x0C45,
    0x0C46,
    0x0C49,
    0x0C4A,
    0x0C4E,
    0x0C55,
    0x0C57,
    0x0C62,
    0x0C64,
    0x0C81,
    0x0C82,
    0x0C84,
    0x0CBC,
    0x0CBD,
    0x0CBE,
    0x0CBF,
    0x0CC0,
    0x0CC2,
    0x0CC3,
    0x0CC5,
    0x0CC6,
    0x0CC7,
    0x0CC9,
    0x0CCA,
    0x0CCC,
    0x0CCE,
    0x0CD5,
    0x0CD7,
    0x0CE2,
    0x0CE4,
    0x0CF3,
    0x0CF4,
    0x0D00,
    0x0D02,
    0x0D04,
    0x0D3B,
    0x0D3D,
    0x0D3E,
    0x0D3F,
    0x0D41,
    0x0D45,
    0x0D46,
    0x0D49,
    0x0D4A,
    0x0D4D,
    0x0D4E,
    0x0D4F,
    0x0D57,
    0x0D58,
    0x0D62,
    0x0D64,
    0x0D81,
    0x0D82,
    0x0D84,
    0x0DCA,
    0x0DCB,
    0x0DCF,
    0x0DD0,
    0x0DD2,
    0x0DD5,
    0x0DD6,
    0x0DD7,
    0x0DD8,
    0x0DDF,
    0x0DE0,
    0x0DF2,
    0x0DF4,
    0x0E31,
    0x0E32,
    0x0E33,
    0x0E34,
    0x0E3B,
    0x0E47,
    0x0E4F,
    0x0EB1,
    0x0EB2,
    0x0EB3,
    0x0EB4,
    0x0EBD,
    0x0EC8,
    0x0ECF,
    0x0F18,
    0x0F1A,
    0x0F35,
    0x0F36,
    0x0F37,
    0x0F38,
    0x0F39,
    0x0F3A,
    0x0F3E,
    0x0F40,
    0x0F71,
    0x0F7F,
    0x0F80,
    0x0F85,
    0x0F86,
    0x0F88,
    0x0F8D,
    0x0F98,
    0x0F99,
    0x0FBD,
    0x0FC6,
    0x0FC7,
    0x102D,
    0x1031,
    0x1032,
    0x1038,
    0x1039,
    0x103B,
    0x103D,
    0x103F,
    0x1056,
    0x1058,
    0x105A,
    0x105E,
    0x1061,
    0x1071,
    0x1075,
    0x1082,
    0x1083,
    0x1084,
    0x1085,
    0x1087,
    0x108D,
    0x108E,
    0x109D,
    0x109E,
    0x1100,
    0x1160,
    0x11A8,
    0x1200,
    0x135D,
    0x1360,
    0x1712,
    0x1715,
    0x1716,
    0x1732,
    0x1734,
    0x1735,
    0x1752,
    0x1754,
    0x1772,
    0x1774,
    0x17B4,
    0x17B6,
    0x17B7,
    0x17BE,
    0x17C6,
    0x17C7,
    0x17C9,
    0x17D4,
    0x17DD,
    0x17DE,
    0x180B,
    0x180E,
    0x180F,
    0x1810,
    0x1885,
    0x1887,
    0x18A9,
    0x18AA,
    0x1920,
    0x1923,
    0x1927,
    0x1929,
    0x192C,
    0x1930,
    0x1932,
    0x1933,
    0x1939,
    0x193C,
    0x1A17,
    0x1A19,
    0x1A1B,
    0x1A1C,
    0x1A55,
    0x1A56,
    0x1A57,
    0x1A58,
    0x1A5F,
    0x1A60,
    0x1A61,
    0x1A62,
    0x1A63,
    0x1A65,
    0x1A6D,
    0x1A73,
    0x1A7D,
    0x1A7F,
    0x1A80,
    0x1AB0,
    0x1ACF,
    0x1B00,
    0x1B04,
    0x1B05,
    0x1B34,
    0x1B3B,
    0x1B3C,
    0x1B3D,
    0x1B42,
    0x1B43,
    0x1B45,
    0x1B6B,
    0x1B74,
    0x1B80,
    0x1B82,
    0x1B83,
    0x1BA1,
    0x1BA2,
    0x1BA6,
    0x1BA8,
    0x1BAA,
    0x1BAB,
    0x1BAE,
    0x1BE6,
    0x1BE7,
    0x1BE8,
    0x1BEA,
    0x1BED,
    0x1BEE,
    0x1BEF,
    0x1BF2,
    0x1BF4,
    0x1C24,
    0x1C2C,
    0x1C34,
    0x1C36,
    0x1C38,
    0x1CD0,
    0x1CD3,
    0x1CD4,
    0x1CE1,
    0x1CE2,
    0x1CE9,
    0x1CED,
    0x1CEE,
    0x1CF4,
    0x1CF5,
    0x1CF7,
    0x1CF8,
    0x1CFA,
    0x1DC0,
    0x1E00,
    0x200B,
    0x200C,
    0x200D,
    0x200E,
    0x2010,
    0x2028,
    0x202F,
    0x2060,
    0x2070,
    0x20D0,
    0x20F1,
    0x2CEF,
    0x2CF2,
    0x2D7F,
    0x2D80,
    0x2DE0,
    0x2E00,
    0x302A,
    0x3030,
    0x3099,
    0x309B,
    0xA66F,
    0xA673,
    0xA674,
    0xA67E,
    0xA69E,
    0xA6A0,
    0xA6F0,
    0xA6F2,
    0xA802,
    0xA803,
    0xA806,
    0xA807,
    0xA80B,
    0xA80C,
    0xA823,
    0xA825,
    0xA827,
    0xA828,
    0xA82C,
    0xA82D,
    0xA880,
    0xA882,
    0xA8B4,
    0xA8C4,
    0xA8C6,
    0xA8E0,
    0xA8F2,
    0xA8FF,
    0xA900,
    0xA926,
    0xA92E,
    0xA947,
    0xA952,
    0xA954,
    0xA960,
    0xA97D,
    0xA980,
    0xA983,
    0xA984,
    0xA9B3,
    0xA9B4,
    0xA9B6,
    0xA9BA,
    0xA9BC,
    0xA9BE,
    0xA9C1,
    0xA9E5,
    0xA9E6,
    0xAA29,
    0xAA2F,
    0xAA31,
    0xAA33,
    0xAA35,
    0xAA37,
    0xAA43,
    0xAA44,
    0xAA4C,
    0xAA4D,
    0xAA4E,
    0xAA7C,
    0xAA7D,
    0xAAB0,
    0xAAB1,
    0xAAB2,
    0xAAB5,
    0xAAB7,
    0xAAB9,
    0xAABE,
    0xAAC0,
    0xAAC1,
    0xAAC2,
    0xAAEB,
    0xAAEC,
    0xAAEE,
    0xAAF0,
    0xAAF5,
    0xAAF6,
    0xAAF7,
    0xABE3,
    0xABE5,
    0xABE6,
    0xABE8,
    0xABE9,
    0xABEB,
    0xABEC,
    0xABED,
    0xABEE,
    0xAC00,
    0xAC01,
    0xAC1C,
    0xAC1D,
    0xAC38,
    0xAC39,
    0xAC54,
    0xAC55,
    0xAC70,
    0xAC71,
    0xAC8C,
    0xAC8D,
    0xACA8,
    0xACA9,
    0xACC4,
    0xACC5,
    0xACE0,
    0xACE1,
    0xACFC,
    0xACFD,
    0xAD18,
    0xAD19,
    0xAD34,
    0xAD35,
    0xAD50,
    0xAD51,
    0xAD6C,
    0xAD6D,
    0xAD88,
    0xAD89,
    0xADA4,
    0xADA5,
    0xADC0,
    0xADC1,
    0xADDC,
    0xADDD,
    0xADF8,
    0xADF9,
    0xAE14,
    0xAE15,
    0xAE30,
    0xAE31,
    0xAE4C,
    0xAE4D,
    0xAE68,
    0xAE69,
    0xAE84,
    0xAE85,
    0xAEA0,
    0xAEA1,
    0xAEBC,
    0xAEBD,
    0xAED8,
    0xAED9,
    0xAEF4,
    0xAEF5,
    0xAF10,
    0xAF11,
    0xAF2C,
    0xAF2D,
    0xAF48,
    0xAF49,
    0xAF64,
    0xAF65,
    0xAF80,
    0xAF81,
    0xAF9C,
    0xAF9D,
    0xAFB8,
    0xAFB9,
    0xAFD4,
    0xAFD5,
    0xAFF0,
    0xAFF1,
    0xB00C,
    0xB00D,
    0xB028,
    0xB029,
    0xB044,
    0xB045,
    0xB060,
    0xB061,
    0xB07C,
    0xB07D,
    0xB098,
    0xB099,
    0xB0B4,
    0xB0B5,
    0xB0D0,
    0xB0D1,
    0xB0EC,
    0xB0ED,
    0xB108,
    0xB109,
    0xB124,
    0xB125,
    0xB140,
    0xB141,
    0xB15C,
    0xB15D,
    0xB178,
    0xB179,
    0xB194,
    0xB195,
    0xB1B0,
    0xB1B1,
    0xB1CC,
    0xB1CD,
    0xB1E8,
    0xB1E9,
    0xB204,
    0xB205,
    0xB220,
    0xB221,
    0xB23C,
    0xB23D,
    0xB258,
    0xB259,
    0xB274,
    0xB275,
    0xB290,
    0xB291,
    0xB2AC,
    0xB2AD,
    0xB2C8,
    0xB2C9,
    0xB2E4,
    0xB2E5,
    0xB300,
    0xB301,
    0xB31C,
    0xB31D,
    0xB338,
    0xB339,
    0xB354,
    0xB355,
    0xB370,
    0xB371,
    0xB38C,
    0xB38D,
    0xB3A8,
    0xB3A9,
    0xB3C4,
    0xB3C5,
    0xB3E0,
    0xB3E1,
    0xB3FC,
    0xB3FD,
    0xB418,
    0xB419,
    0xB434,
    0xB435,
    0xB450,
    0xB451,
    0xB46C,
    0xB46D,
    0xB488,
    0xB489,
    0xB4A4,
    0xB4A5,
    0xB4C0,
    0xB4C1,
    0xB4DC,
    0xB4DD,
    0xB4F8,
    0xB4F9,
    0xB514,
    0xB515,
    0xB530,
    0xB531,
    0xB54C,
    0xB54D,
    0xB568,
    0xB569,
    0xB584,
    0xB585,
    0xB5A0,
    0xB5A1,
    0xB5BC,
    0xB5BD,
    0xB5D8,
    0xB5D9,
    0xB5F4,
    0xB5F5,
    0xB610,
    0xB611,
    0xB62C,
    0xB62D,
    0xB648,
    0xB649,
    0xB664,
    0xB665,
    0xB680,
    0xB681,
    0xB69C,
    0xB69D,
    0xB6B8,
    0xB6B9,
    0xB6D4,
    0xB6D5,
    0xB6F0,
    0xB6F1,
    0xB70C,
    0xB70D,
    0xB728,
    0xB729,
    0xB744,
    0xB745,
    0xB760,
    0xB761,
    0xB77C,
    0xB77D,
    0xB798,
    0xB799,
    0xB7B4,
    0xB7B5,
    0xB7D0,
    0xB7D1,
    0xB7EC,
    0xB7ED,
    0xB808,
    0xB809,
    0xB824,
    0xB825,
    0xB840,
    0xB841,
    0xB85C,
    0xB85D,
    0xB878,
    0xB879,
    0xB894,
    0xB895,
    0xB8B0,
    0xB8B1,
    0xB8CC,
    0xB8CD,
    0xB8E8,
    0xB8E9,
    0xB904,
    0xB905,
    0xB920,
    0xB921,
    0xB93C,
    0xB93D,
    0xB958,
    0xB959,
    0xB974,
    0xB975,
    0xB990,
    0xB991,
    0xB9AC,
    0xB9AD,
    0xB9C8,
    0xB9C9,
    0xB9E4,
    0xB9E5,
    0xBA00,
    0xBA01,
    0xBA1C,
    0xBA1D,
    0xBA38,
    0xBA39,
    0xBA54,
    0xBA55,
    0xBA70,
    0xBA71,
    0xBA8C,
    0xBA8D,
    0xBAA8,
    0xBAA9,
    0xBAC4,
    0xBAC5,
    0xBAE0,
    0xBAE1,
    0xBAFC,
    0xBAFD,
    0xBB18,
    0xBB19,
    0xBB34,
    0xBB35,
    0xBB50,
    0xBB51,
    0xBB6C,
    0xBB6D,
    0xBB88,
    0xBB89,
    0xBBA4,
    0xBBA5,
    0xBBC0,
    0xBBC1,
    0xBBDC,
    0xBBDD,
    0xBBF8,
    0xBBF9,
    0xBC14,
    0xBC15,
    0xBC30,
    0xBC31,
    0xBC4C,
    0xBC4D,
    0xBC68,
    0xBC69,
    0xBC84,
    0xBC85,
    0xBCA0,
    0xBCA1,
    0xBCBC,
    0xBCBD,
    0xBCD8,
    0xBCD9,
    0xBCF4,
    0xBCF5,
    0xBD10,
    0xBD11,
    0xBD2C,
    0xBD2D,
    0xBD48,
    0xBD49,
    0xBD64,
    0xBD65,
    0xBD80,
    0xBD81,
    0xBD9C,
    0xBD9D,
    0xBDB8,
    0xBDB9,
    0xBDD4,
    0xBDD5,
    0xBDF0,
    0xBDF1,
    0xBE0C,
    0xBE0D,
    0xBE28,
    0xBE29,
    0xBE44,
    0xBE45,
    0xBE60,
    0xBE61,
    0xBE7C,
    0xBE7D,
    0xBE98,
    0xBE99,
    0xBEB4,
    0xBEB5,
    0xBED0,
    0xBED1,
    0xBEEC,
    0xBEED,
    0xBF08,
    0xBF09,
    0xBF24,
    0xBF25,
    0xBF40,
    0xBF41,
    0xBF5C,
    0xBF5D,
    0xBF78,
    0xBF79,
    0xBF94,
    0xBF95,
    0xBFB0,
    0xBFB1,
    0xBFCC,
    0xBFCD,
    0xBFE8,
    0xBFE9,
    0xC004,
    0xC005,
    0xC020,
    0xC021,
    0xC03C,
    0xC03D,
    0xC058,
    0xC059,
    0xC074,
    0xC075,
    0xC090,
    0xC091,
    0xC0AC,
    0xC0AD,
    0xC0C8,
    0xC0C9,
    0xC0E4,
    0xC0E5,
    0xC100,
    0xC101,
    0xC11C,
    0xC11D,
    0xC138,
    0xC139,
    0xC154,
    0xC155,
    0xC170,
    0xC171,
    0xC18C,
    0xC18D,
    0xC1A8,
    0xC1A9,
    0xC1C4,
    0xC1C5,
    0xC1E0,
    0xC1E1,
    0xC1FC,
    0xC1FD,
    0xC218,
    0xC219,
    0xC234,
    0xC235,
    0xC250,
    0xC251,
    0xC26C,
    0xC26D,
    0xC288,
    0xC289,
    0xC2A4,
    0xC2A5,
    0xC2C0,
    0xC2C1,
    0xC2DC,
    0xC2DD,
    0xC2F8,
    0xC2F9,
    0xC314,
    0xC315,
    0xC330,
    0xC331,
    0xC34C,
    0xC34D,
    0xC368,
    0xC369,
    0xC384,
    0xC385,
    0xC3A0,
    0xC3A1,
    0xC3BC,
    0xC3BD,
    0xC3D8,
    0xC3D9,
    0xC3F4,
    0xC3F5,
    0xC410,
    0xC411,
    0xC42C,
    0xC42D,
    0xC448,
    0xC449,
    0xC464,
    0xC465,
    0xC480,
    0xC481,
    0xC49C,
    0xC49D,
    0xC4B8,
    0xC4B9,
    0xC4D4,
    0xC4D5,
    0xC4F0,
    0xC4F1,
    0xC50C,
    0xC50D,
    0xC528,
    0xC529,
    0xC544,
    0xC545,
    0xC560,
    0xC561,
    0xC57C,
    0xC57D,
    0xC598,
    0xC599,
    0xC5B4,
    0xC5B5,
    0xC5D0,
    0xC5D1,
    0xC5EC,
    0xC5ED,
    0xC608,
    0xC609,
    0xC624,
    0xC625,
    0xC640,
    0xC641,
    0xC65C,
    0xC65D,
    0xC678,
    0xC679,
    0xC694,
    0xC695,
    0xC6B0,
    0xC6B1,
    0xC6CC,
    0xC6CD,
    0xC6E8,
    0xC6E9,
    0xC704,
    0xC705,
    0xC720,
    0xC721,
    0xC73C,
    0xC73D,
    0xC758,
    0xC759,
    0xC774,
    0xC775,
    0xC790,
    0xC791,
    0xC7AC,
    0xC7AD,
    0xC7C8,
    0xC7C9,
    0xC7E4,
    0xC7E5,
    0xC800,
    0xC801,
    0xC81C,
    0xC81D,
    0xC838,
    0xC839,
    0xC854,
    0xC855,
    0xC870,
    0xC871,
    0xC88C,
    0xC88D,
    0xC8A8,
    0xC8A9,
    0xC8C4,
    0xC8C5,
    0xC8E0,
    0xC8E1,
    0xC8FC,
    0xC8FD,
    0xC918,
    0xC919,
    0xC934,
    0xC935,
    0xC950,
    0xC951,
    0xC96C,
    0xC96D,
    0xC988,
    0xC989,
    0xC9A4,
    0xC9A5,
    0xC9C0,
    0xC9C1,
    0xC9DC,
    0xC9DD,
    0xC9F8,
    0xC9F9,
    0xCA14,
    0xCA15,
    0xCA30,
    0xCA31,
    0xCA4C,
    0xCA4D,
    0xCA68,
    0xCA69,
    0xCA84,
    0xCA85,
    0xCAA0,
    0xCAA1,
    0xCABC,
    0xCABD,
    0xCAD8,
    0xCAD9,
    0xCAF4,
    0xCAF5,
    0xCB10,
    0xCB11,
    0xCB2C,
    0xCB2D,
    0xCB48,
    0xCB49,
    0xCB64,
    0xCB65,
    0xCB80,
    0xCB81,
    0xCB9C,
    0xCB9D,
    0xCBB8,
    0xCBB9,
    0xCBD4,
    0xCBD5,
    0xCBF0,
    0xCBF1,
    0xCC0C,
    0xCC0D,
    0xCC28,
    0xCC29,
    0xCC44,
    0xCC45,
    0xCC60,
    0xCC61,
    0xCC7C,
    0xCC7D,
    0xCC98,
    0xCC99,
    0xCCB4,
    0xCCB5,
    0xCCD0,
    0xCCD1,
    0xCCEC,
    0xCCED,
    0xCD08,
    0xCD09,
    0xCD24,
    0xCD25,
    0xCD40,
    0xCD41,
    0xCD5C,
    0xCD5D,
    0xCD78,
    0xCD79,
    0xCD94,
    0xCD95,
    0xCDB0,
    0xCDB1,
    0xCDCC,
    0xCDCD,
    0xCDE8,
    0xCDE9,
    0xCE04,
    0xCE05,
    0xCE20,
    0xCE21,
    0xCE3C,
    0xCE3D,
    0xCE58,
    0xCE59,
    0xCE74,
    0xCE75,
    0xCE90,
    0xCE91,
    0xCEAC,
    0xCEAD,
    0xCEC8,
    0xCEC9,
    0xCEE4,
    0xCEE5,
    0xCF00,
    0xCF01,
    0xCF1C,
    0xCF1D,
    0xCF38,
    0xCF39,
    0xCF54,
    0xCF55,
    0xCF70,
    0xCF71,
    0xCF8C,
    0xCF8D,
    0xCFA8,
    0xCFA9,
    0xCFC4,
    0xCFC5,
    0xCFE0,
    0xCFE1,
    0xCFFC,
    0xCFFD,
    0xD018,
    0xD019,
    0xD034,
    0xD035,
    0xD050,
    0xD051,
    0xD06C,
    0xD06D,
    0xD088,
    0xD089,
    0xD0A4,
    0xD0A5,
    0xD0C0,
    0xD0C1,
    0xD0DC,
    0xD0DD,
    0xD0F8,
    0xD0F9,
    0xD114,
    0xD115,
    0xD130,
    0xD131,
    0xD14C,
    0xD14D,
    0xD168,
    0xD169,
    0xD184,
    0xD185,
    0xD1A0,
    0xD1A1,
    0xD1BC,
    0xD1BD,
    0xD1D8,
    0xD1D9,
    0xD1F4,
    0xD1F5,
    0xD210,
    0xD211,
    0xD22C,
    0xD22D,
    0xD248,
    0xD249,
    0xD264,
    0xD265,
    0xD280,
    0xD281,
    0xD29C,
    0xD29D,
    0xD2B8,
    0xD2B9,
    0xD2D4,
    0xD2D5,
    0xD2F0,
    0xD2F1,
    0xD30C,
    0xD30D,
    0xD328,
    0xD329,
    0xD344,
    0xD345,
    0xD360,
    0xD361,
    0xD37C,
    0xD37D,
    0xD398,
    0xD399,
    0xD3B4,
    0xD3B5,
    0xD3D0,
    0xD3D1,
    0xD3EC,
    0xD3ED,
    0xD408,
    0xD409,
    0xD424,
    0xD425,
    0xD440,
    0xD441,
    0xD45C,
    0xD45D,
    0xD478,
    0xD479,
    0xD494,
    0xD495,
    0xD4B0,
    0xD4B1,
    0xD4CC,
    0xD4CD,
    0xD4E8,
    0xD4E9,
    0xD504,
    0xD505,
    0xD520,
    0xD521,
    0xD53C,
    0xD53D,
    0xD558,
    0xD559,
    0xD574,
    0xD575,
    0xD590,
    0xD591,
    0xD5AC,
    0xD5AD,
    0xD5C8,
    0xD5C9,
    0xD5E4,
    0xD5E5,
    0xD600,
    0xD601,
    0xD61C,
    0xD61D,
    0xD638,
    0xD639,
    0xD654,
    0xD655,
    0xD670,
    0xD671,
    0xD68C,
    0xD68D,
    0xD6A8,
    0xD6A9,
    0xD6C4,
    0xD6C5,
    0xD6E0,
    0xD6E1,
    0xD6FC,
    0xD6FD,
    0xD718,
    0xD719,
    0xD734,
    0xD735,
    0xD750,
    0xD751,
    0xD76C,
    0xD76D,
    0xD788,
    0xD789,
    0xD7A4,
    0xD7B0,
    0xD7C7,
    0xD7CB,
    0xD7FC,
    0xFB1E,
    0xFB1F,
    0xFE00,
    0xFE10,
    0xFE20,
    0xFE30,
    0xFEFF,
    0xFF00,
    0xFF9E,
    0xFFA0,
    0xFFF0,
    0xFFFC,
    0x101FD,
    0x101FE,
    0x102E0,
    0x102E1,
    0x10376,
    0x1037B,
    0x10A01,
    0x10A04,
    0x10A05,
    0x10A07,
    0x10A0C,
    0x10A10,
    0x10A38,
    0x10A3B,
    0x10A3F,
    0x10A40,
    0x10AE5,
    0x10AE7,
    0x10D24,
    0x10D28,
    0x10EAB,
    0x10EAD,
    0x10EFD,
    0x10F00,
    0x10F46,
    0x10F51,
    0x10F82,
    0x10F86,
    0x11000,
    0x11001,
    0x11002,
    0x11003,
    0x11038,
    0x11047,
    0x11070,
    0x11071,
    0x11073,
    0x11075,
    0x1107F,
    0x11082,
    0x11083,
    0x110B0,
    0x110B3,
    0x110B7,
    0x110B9,
    0x110BB,
    0x110BD,
    0x110BE,
    0x110C2,
    0x110C3,
    0x110CD,
    0x110CE,
    0x11100,
    0x11103,
    0x11127,
    0x1112C,
    0x1112D,
    0x11135,
    0x11145,
    0x11147,
    0x11173,
    0x11174,
    0x11180,
    0x11182,
    0x11183,
    0x111B3,
    0x111B6,
    0x111BF,
    0x111C1,
    0x111C2,
    0x111C4,
    0x111C9,
    0x111CD,
    0x111CE,
    0x111CF,
    0x111D0,
    0x1122C,
    0x1122F,
    0x11232,
    0x11234,
    0x11235,
    0x11236,
    0x11238,
    0x1123E,
    0x1123F,
    0x11241,
    0x11242,
    0x112DF,
    0x112E0,
    0x112E3,
    0x112EB,
    0x11300,
    0x11302,
    0x11304,
    0x1133B,
    0x1133D,
    0x1133E,
    0x1133F,
    0x11340,
    0x11341,
    0x11345,
    0x11347,
    0x11349,
    0x1134B,
    0x1134E,
    0x11357,
    0x11358,
    0x11362,
    0x11364,
    0x11366,
    0x1136D,
    0x11370,
    0x11375,
    0x11435,
    0x11438,
    0x11440,
    0x11442,
    0x11445,
    0x11446,
    0x11447,
    0x1145E,
    0x1145F,
    0x114B0,
    0x114B1,
    0x114B3,
    0x114B9,
    0x114BA,
    0x114BB,
    0x114BD,
    0x114BE,
    0x114BF,
    0x114C1,
    0x114C2,
    0x114C4,
    0x115AF,
    0x115B0,
    0x115B2,
    0x115B6,
    0x115B8,
    0x115BC,
    0x115BE,
    0x115BF,
    0x115C1,
    0x115DC,
    0x115DE,
    0x11630,
    0x11633,
    0x1163B,
    0x1163D,
    0x1163E,
    0x1163F,
    0x11641,
    0x116AB,
    0x116AC,
    0x116AD,
    0x116AE,
    0x116B0,
    0x116B6,
    0x116B7,
    0x116B8,
    0x1171D,
    0x11720,
    0x11722,
    0x11726,
    0x11727,
    0x1172C,
    0x1182C,
    0x1182F,
    0x11838,
    0x11839,
    0x1183B,
    0x11930,
    0x11931,
    0x11936,
    0x11937,
    0x11939,
    0x1193B,
    0x1193D,
    0x1193E,
    0x1193F,
    0x11940,
    0x11941,
    0x11942,
    0x11943,
    0x11944,
    0x119D1,
    0x119D4,
    0x119D8,
    0x119DA,
    0x119DC,
    0x119E0,
    0x119E1,
    0x119E4,
    0x119E5,
    0x11A01,
    0x11A0B,
    0x11A33,
    0x11A39,
    0x11A3A,
    0x11A3B,
    0x11A3F,
    0x11A47,
    0x11A48,
    0x11A51,
    0x11A57,
    0x11A59,
    0x11A5C,
    0x11A84,
    0x11A8A,
    0x11A97,
    0x11A98,
    0x11A9A,
    0x11C2F,
    0x11C30,
    0x11C37,
    0x11C38,
    0x11C3E,
    0x11C3F,
    0x11C40,
    0x11C92,
    0x11CA8,
    0x11CA9,
    0x11CAA,
    0x11CB1,
    0x11CB2,
    0x11CB4,
    0x11CB5,
    0x11CB7,
    0x11D31,
    0x11D37,
    0x11D3A,
    0x11D3B,
    0x11D3C,
    0x11D3E,
    0x11D3F,
    0x11D46,
    0x11D47,
    0x11D48,
    0x11D8A,
    0x11D8F,
    0x11D90,
    0x11D92,
    0x11D93,
    0x11D95,
    0x11D96,
    0x11D97,
    0x11D98,
    0x11EF3,
    0x11EF5,
    0x11EF7,
    0x11F00,
    0x11F02,
    0x11F03,
    0x11F04,
    0x11F34,
    0x11F36,
    0x11F3B,
    0x11F3E,
    0x11F40,
    0x11F41,
    0x11F42,
    0x11F43,
    0x13430,
    0x13440,
    0x13441,
    0x13447,
    0x13456,
    0x16AF0,
    0x16AF5,
    0x16B30,
    0x16B37,
    0x16F4F,
    0x16F50,
    0x16F51,
    0x16F88,
    0x16F8F,
    0x16F93,
    0x16FE4,
    0x16FE5,
    0x16FF0,
    0x16FF2,
    0x1BC9D,
    0x1BC9F,
    0x1BCA0,
    0x1BCA4,
    0x1CF00,
    0x1CF2E,
    0x1CF30,
    0x1CF47,
    0x1D165,
    0x1D166,
    0x1D167,
    0x1D16A,
    0x1D16D,
    0x1D16E,
    0x1D173,
    0x1D17B,
    0x1D183,
    0x1D185,
    0x1D18C,
    0x1D1AA,
    0x1D1AE,
    0x1D242,
    0x1D245,
    0x1DA00,
    0x1DA37,
    0x1DA3B,
    0x1DA6D,
    0x1DA75,
    0x1DA76,
    0x1DA84,
    0x1DA85,
    0x1DA9B,
    0x1DAA0,
    0x1DAA1,
    0x1DAB0,
    0x1E000,
    0x1E007,
    0x1E008,
    0x1E019,
    0x1E01B,
    0x1E022,
    0x1E023,
    0x1E025,
    0x1E026,
    0x1E02B,
    0x1E08F,
    0x1E090,
    0x1E130,
    0x1E137,
    0x1E2AE,
    0x1E2AF,
    0x1E2EC,
    0x1E2F0,
    0x1E4EC,
    0x1E4F0,
    0x1E8D0,
    0x1E8D7,
    0x1E944,
    0x1E94B,
    0x1F1E6,
    0x1F200,
    0x1F3FB,
    0x1F400,
    0xE0000,
    0xE0020,
    0xE0080,
    0xE0100,
    0xE01F0,
    0xE1000,
)

GCB_IDS = (
    0,  # CN
    4,  # LF
    0,  # CN
    1,  # CR
    0,  # CN
    12,  # XX
    0,  # CN
    12,  # XX
    0,  # CN
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    7,  # PP
    12,  # XX
    2,  # EX
    12,  # XX
    0,  # CN
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    7,  # PP
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    7,  # PP
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    7,  # PP
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    7,  # PP
    2,  # EX
    9,  # SM
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    9,  # SM
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    9,  # SM
    12,  # XX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    12,  # XX
    2,  # EX
    12,  # XX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    12,  # XX
    2,  # EX
    12,  # XX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    12,  # XX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    9,  # SM
    12,  # XX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    9,  # SM
    12,  # XX
    9,  # SM
    12,  # XX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    12,  # XX
    2,  # EX
    12,  # XX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    9,  # SM
    12,  # XX
    2,  # EX
    9,  # SM
    12,  # XX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    9,  # SM
    12,  # XX
    2,  # EX
    9,  # SM
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    9,  # SM
    12,  # XX
    9,  # SM
    2,  # EX
    7,  # PP
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    9,  # SM
    2,  # EX
    12,  # XX
    9,  # SM
    12,  # XX
    2,  # EX
    12,  # XX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    9,  # SM
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    3,  # L
    11,  # V
    10,  # T
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    12,  # XX
    2,  # EX
    9,  # SM
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    0,  # CN
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    9,  # SM
    12,  # XX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    9,  # SM
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    12,  # XX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    9,  # SM
    12,  # XX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    0,  # CN
    2,  # EX
    13,  # ZWJ
    0,  # CN
    12,  # XX
    0,  # CN
    12,  # XX
    0,  # CN
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    9,  # SM
    2,  # EX
    9,  # SM
    12,  # XX
    2,  # EX
    12,  # XX
    9,  # SM
    12,  # XX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    12,  # XX
    3,  # L
    12,  # XX
    2,  # EX
    9,  # SM
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    9,  # SM
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    9,  # SM
    2,  # EX
    9,  # SM
    12,  # XX
    9,  # SM
    2,  # EX
    12,  # XX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    9,  # SM
    12,  # XX
    9,  # SM
    2,  # EX
    12,  # XX
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    5,  # LV
    6,  # LVT
    12,  # XX
    11,  # V
    12,  # XX
    10,  # T
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    0,  # CN
    12,  # XX
    2,  # EX
    12,  # XX
    0,  # CN
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    9,  # SM
    2,  # EX
    9,  # SM
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    12,  # XX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    7,  # PP
    12,  # XX
    2,  # EX
    12,  # XX
    7,  # PP
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    9,  # SM
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    12,  # XX
    9,  # SM
    2,  # EX
    9,  # SM
    12,  # XX
    7,  # PP
    12,  # XX
    2,  # EX
    12,  # XX
    9,  # SM
    2,  # EX
    12,  # XX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    9,  # SM
    12,  # XX
    9,  # SM
    12,  # XX
    9,  # SM
    12,  # XX
    2,  # EX
    12,  # XX
    9,  # SM
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    12,  # XX
    9,  # SM
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    7,  # PP
    9,  # SM
    7,  # PP
    9,  # SM
    2,  # EX
    12,  # XX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    9,  # SM
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    7,  # PP
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    7,  # PP
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    7,  # PP
    2,  # EX
    12,  # XX
    9,  # SM
    12,  # XX
    2,  # EX
    12,  # XX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    12,  # XX
    2,  # EX
    7,  # PP
    9,  # SM
    12,  # XX
    9,  # SM
    2,  # EX
    12,  # XX
    9,  # SM
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    0,  # CN
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    9,  # SM
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    9,  # SM
    12,  # XX
    2,  # EX
    12,  # XX
    0,  # CN
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    9,  # SM
    2,  # EX
    12,  # XX
    9,  # SM
    2,  # EX
    0,  # CN
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    2,  # EX
    12,  # XX
    8,  # RI
    12,  # XX
    2,  # EX
    12,  # XX
    0,  # CN
    2,  # EX
    0,  # CN
    2,  # EX
    0,  # CN
    12,  # XX
)

EXTPICT = (
    (0x00A9, 0x00A9),
    (0x00AE, 0x00AE),
    (0x203C, 0x203C),
    (0x2049, 0x2049),
    (0x2122, 0x2122),
    (0x2139, 0x2139),
    (0x2194, 0x2199),
    (0x21A9, 0x21AA),
    (0x231A, 0x231B),
    (0x2328, 0x2328),
    (0x2388, 0x2388),
    (0x23CF, 0x23CF),
    (0x23E9, 0x23F3),
    (0x23F8, 0x23FA),
    (0x24C2, 0x24C2),
    (0x25AA, 0x25AB),
    (0x25B6, 0x25B6),
    (0x25C0, 0x25C0),
    (0x25FB, 0x25FE),
    (0x2600, 0x2605),
    (0x2607, 0x2612),
    (0x2614, 0x2685),
    (0x2690, 0x2705),
    (0x2708, 0x2712),
    (0x2714, 0x2714),
    (0x2716, 0x2716),
    (0x271D, 0x271D),
    (0x2721, 0x2721),
    (0x2728, 0x2728),
    (0x2733, 0x2734),
    (0x2744, 0x2744),
    (0x2747, 0x2747),
    (0x274C, 0x274C),
    (0x274E, 0x274E),
    (0x2753, 0x2755),
    (0x2757, 0x2757),
    (0x2763, 0x2767),
    (0x2795, 0x2797),
    (0x27A1, 0x27A1),
    (0x27B0, 0x27B0),
    (0x27BF, 0x27BF),
    (0x2934, 0x2935),
    (0x2B05, 0x2B07),
    (0x2B1B, 0x2B1C),
    (0x2B50, 0x2B50),
    (0x2B55, 0x2B55),
    (0x3030, 0x3030),
    (0x303D, 0x303D),
    (0x3297, 0x3297),
    (0x3299, 0x3299),
    (0x1F000, 0x1F0FF),
    (0x1F10D, 0x1F10F),
    (0x1F12F, 0x1F12F),
    (0x1F16C, 0x1F171),
    (0x1F17E, 0x1F17F),
    (0x1F18E, 0x1F18E),
    (0x1F191, 0x1F19A),
    (0x1F1AD, 0x1F1E5),
    (0x1F201, 0x1F20F),
    (0x1F21A, 0x1F21A),
    (0x1F22F, 0x1F22F),
    (0x1F232, 0x1F23A),
    (0x1F23C, 0x1F23F),
    (0x1F249, 0x1F3FA),
    (0x1F400, 0x1F53D),
    (0x1F546, 0x1F64F),
    (0x1F680, 0x1F6FF),
    (0x1F774, 0x1F77F),
    (0x1F7D5, 0x1F7FF),
    (0x1F80C, 0x1F80F),
    (0x1F848, 0x1F84F),
    (0x1F85A, 0x1F85F),
    (0x1F888, 0x1F88F),
    (0x1F8AE, 0x1F8FF),
    (0x1F90C, 0x1F93A),
    (0x1F93C, 0x1F945),
    (0x1F947, 0x1FAFF),
    (0x1FC00, 0x1FFFD),
)
