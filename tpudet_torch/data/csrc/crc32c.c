/* crc32c (Castagnoli) — slicing-by-8, for TFRecord framing checksums.
 *
 * The port's own copy of tpudet's native/crc32c.c, loaded via ctypes by
 * tpudet_torch/data/tfrecord.py, which builds it at first use into build/native/:
 *   g++ -O3 -fPIC -shared crc32c.c -o crc32c-<hash>.so
 */

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

static uint32_t table[8][256];
static int initialized = 0;

static void init_tables(void) {
    const uint32_t poly = 0x82F63B78u; /* reflected 0x1EDC6F41 */
    for (int i = 0; i < 256; i++) {
        uint32_t crc = (uint32_t)i;
        for (int j = 0; j < 8; j++)
            crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
        table[0][i] = crc;
    }
    for (int i = 0; i < 256; i++) {
        uint32_t crc = table[0][i];
        for (int k = 1; k < 8; k++) {
            crc = table[0][crc & 0xFF] ^ (crc >> 8);
            table[k][i] = crc;
        }
    }
    initialized = 1;
}

uint32_t tpudet_crc32c(const uint8_t *data, size_t n, uint32_t seed) {
    if (!initialized) init_tables();
    uint32_t crc = seed ^ 0xFFFFFFFFu;
    while (n >= 8) {
        crc ^= (uint32_t)data[0] | ((uint32_t)data[1] << 8) |
               ((uint32_t)data[2] << 16) | ((uint32_t)data[3] << 24);
        uint32_t hi = (uint32_t)data[4] | ((uint32_t)data[5] << 8) |
                      ((uint32_t)data[6] << 16) | ((uint32_t)data[7] << 24);
        crc = table[7][crc & 0xFF] ^ table[6][(crc >> 8) & 0xFF] ^
              table[5][(crc >> 16) & 0xFF] ^ table[4][crc >> 24] ^
              table[3][hi & 0xFF] ^ table[2][(hi >> 8) & 0xFF] ^
              table[1][(hi >> 16) & 0xFF] ^ table[0][hi >> 24];
        data += 8;
        n -= 8;
    }
    while (n--) crc = table[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
    return crc ^ 0xFFFFFFFFu;
}

#ifdef __cplusplus
}
#endif
